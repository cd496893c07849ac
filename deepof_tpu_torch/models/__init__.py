"""Flow models."""
