"""Micro-batching inference engine, shape buckets, precision tiers,
video sessions, and the HTTP server and offline mode over them."""
