"""LiveServe on PyTorch and hand-written CUDA kernels for NVIDIA Hopper.

The port of the JAX package ``repro`` (which stays as the reference it is
held against). It mirrors that package's layout and imports nothing of
it, nor JAX.
"""
