"""Evaluation protocol (host side)."""
