"""Hand-written Hopper kernels (``csrc/*.cu``), their ``ctypes`` wrappers,
and the plain PyTorch versions the wrappers run for CPU tensors."""
