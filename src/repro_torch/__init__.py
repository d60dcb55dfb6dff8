"""repro_torch: the PyTorch + CUDA port of the HAP reproduction for NVIDIA
Hopper (H100). ``repro`` (JAX, Pallas kernels for the TPU) stays the
reference; this package imports nothing of it, and its tests hold it
against it. Entry points run on CUDA unless the caller passes
``device="cpu"``."""
