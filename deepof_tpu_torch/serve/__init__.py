"""Micro-batching inference engine and shape buckets."""
