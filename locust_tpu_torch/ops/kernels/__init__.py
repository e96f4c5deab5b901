"""Hand-written CUDA kernels (``csrc/``) with their wrappers and plain
PyTorch versions: ``tokenize`` (kernel A), ``sort`` (kernel B) and
``fused_fold`` (kernel C)."""


class KernelLaunchError(RuntimeError):
    """A kernel's launch on the card returned a CUDA error."""
