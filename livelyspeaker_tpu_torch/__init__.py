"""PyTorch and CUDA port of ``livelyspeaker_tpu`` for an NVIDIA H100.

The JAX package stays the reference: every module here is held against its
counterpart there by a parity test. Importing this package imports torch and
numpy only; the CUDA kernels build with nvcc at their first launch.
"""
