"""Hand-written CUDA kernels (``csrc/``) with their wrappers and plain
PyTorch versions: ``tokenize`` (kernel A), ``sort`` (kernel B) and
``fused_fold`` (kernel C)."""
