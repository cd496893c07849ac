"""Tensor ops; each hand-written kernel sits beside its plain version."""
