"""Dataset constants and host-side image resize."""
