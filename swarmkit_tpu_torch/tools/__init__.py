"""Command-line tools that measure the port on the CUDA card."""
