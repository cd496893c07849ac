"""Unsupervised photometric pyramid loss."""
