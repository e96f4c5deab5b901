"""Hand-written CUDA kernels (``csrc/``) with their wrappers and plain
PyTorch versions: ``tokenize`` (kernel A) and ``sort`` (kernel B)."""
