"""Device kernels of the port (hand-written CUDA for Hopper)."""
