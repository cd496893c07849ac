"""Micro-batching inference engine, shape buckets, precision tiers,
video sessions, the HTTP server and offline mode over them, and the
fleet: supervised replicas of that server behind a router, with the
autoscaler and the brownout controller."""
