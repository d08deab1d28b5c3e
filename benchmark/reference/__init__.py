"""The plain reference the benchmark holds the port against: plain PyTorch,
importing nothing of the port or of JAX, computed from the benchmark's own
tables."""
