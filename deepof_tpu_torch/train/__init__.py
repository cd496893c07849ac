"""Training (step, optimizer state, loop) and the evaluation protocol."""
