"""Hand-written Hopper kernels, their plain PyTorch versions and the
dispatch seam (``ops``). Importing builds nothing: the kernels compile on
first launch (``_build``)."""
