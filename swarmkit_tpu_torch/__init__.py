"""PyTorch/CUDA port of swarmkit-tpu for one NVIDIA H100.

A second package beside the JAX one: same module layout, same state field
names, bit-identical raft ticks.  It imports torch and numpy only.  Entry
points run on the CUDA card unless the caller passes ``device="cpu"``.
"""
