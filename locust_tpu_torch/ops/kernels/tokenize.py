"""Kernel A: the Map-stage tokenizer (``csrc/tokenize.cu``) and its plain
PyTorch version.

Replaces ``locust_tpu/ops/pallas/tokenize.py`` (``_tokenize_kernel`` via
``tokenize_block_pallas``).  ``tokenize_block_kernel`` launches the CUDA
kernel for a CUDA tensor and takes the plain version, ``tokenize_reference``
(the "gather" formulation of ``locust_tpu/ops/map_stage.tokenize_block``),
only for a CPU tensor.  The kernel's design note is in its source.
"""

from __future__ import annotations

import ctypes

import torch

from locust_tpu_torch import _build
from locust_tpu_torch.config import FULL_DELIMITERS
from locust_tpu_torch.core import bytes_ops


def tokenize_reference(lines: torch.Tensor, emits: int, key_width: int):
    """Plain tokenizer of a ``[L, W]`` uint8 block: keys uint8 ``[L, E, K]``,
    valid bool ``[L, E]``, overflow int32 scalar (tokens past ``emits``)."""
    num_lines, width = lines.shape
    in_token = ~bytes_ops.delimiter_mask(lines)
    starts = bytes_ops.token_starts(in_token)
    tid = bytes_ops.token_ids(starts)
    slot = torch.arange(emits, dtype=torch.int32, device=lines.device)
    ntok = starts.sum(dim=-1, dtype=torch.int32)
    valid = slot[None, :] < torch.clamp(ntok, max=emits)[:, None]

    # Scatter each token's start column into its emit slot; non-starts
    # and tokens past the cap land in a dump slot (index ``emits``).
    padded = torch.nn.functional.pad(lines, (0, key_width))
    w_col = torch.arange(width, device=lines.device).expand(num_lines, width)
    slot_of_col = torch.where(starts, torch.clamp(tid, max=emits), emits).long()
    start_idx = torch.zeros(
        (num_lines, emits + 1), dtype=torch.int64, device=lines.device
    ).scatter_(1, slot_of_col, w_col)[:, :emits]
    idx = start_idx[:, :, None] + torch.arange(key_width, device=lines.device)
    gathered = torch.gather(padded, 1, idx.reshape(num_lines, -1)).reshape(
        num_lines, emits, key_width
    )
    # A token runs until its first delimiter: prefix-AND of the
    # non-delimiter mask over the gathered window.
    live = ~bytes_ops.delimiter_mask(gathered)
    live = torch.cumprod(live.to(torch.uint8), dim=-1).bool()
    keys = torch.where(live & valid[..., None], gathered, torch.zeros_like(gathered))
    overflow = torch.clamp(ntok - emits, min=0).sum(dtype=torch.int32)
    return keys, valid, overflow


def delim_words() -> list[int]:
    """The delimiter set as four 64-bit masks (bit b: byte b ends a token)."""
    words = [0, 0, 0, 0]
    for b in FULL_DELIMITERS:
        words[b >> 6] |= 1 << (b & 63)
    return words


def _lib() -> ctypes.CDLL:
    lib = _build.load("tokenize")
    fn = lib.locust_tokenize
    if fn.argtypes is None:
        p, i, ll, u64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_ulonglong
        fn.argtypes = [p, ll, i, i, i, p, p, p, u64, u64, u64, u64, p]
        fn.restype = ctypes.c_int
        for name in ("locust_tokenize_max_width", "locust_tokenize_max_emits"):
            getattr(lib, name).argtypes = []
            getattr(lib, name).restype = ctypes.c_int
    return lib


def tokenize_block_kernel(lines: torch.Tensor, emits: int, key_width: int):
    """Tokenize a ``[L, W]`` uint8 block: keys uint8 ``[L, E, K]``, valid
    bool ``[L, E]``, overflow int32 scalar.

    A CUDA tensor launches ``csrc/tokenize.cu`` (``launches`` counts the
    launches); a CPU tensor takes ``tokenize_reference``.
    """
    if lines.device.type == "cpu":
        return tokenize_reference(lines, emits, key_width)
    if lines.device.type != "cuda":
        raise ValueError(f"tokenizer: no kernel for device {lines.device}")
    if lines.dtype != torch.uint8 or lines.dim() != 2 or not lines.is_contiguous():
        raise ValueError("tokenizer: lines must be a contiguous uint8 [L, W] tensor")
    if key_width % 4 != 0:
        raise ValueError(f"tokenizer: key_width {key_width} not a multiple of 4")
    lib = _lib()
    num_lines, width = lines.shape
    if width > lib.locust_tokenize_max_width() or emits > lib.locust_tokenize_max_emits():
        raise ValueError(
            f"tokenizer: width {width} or emits {emits} above the kernel's "
            f"bounds ({lib.locust_tokenize_max_width()}, "
            f"{lib.locust_tokenize_max_emits()})"
        )
    dev = lines.device
    keys = torch.empty((num_lines, emits, key_width), dtype=torch.uint8, device=dev)
    valid = torch.empty((num_lines, emits), dtype=torch.bool, device=dev)
    per_line = torch.empty((num_lines,), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = lib.locust_tokenize(
            lines.data_ptr(), num_lines, width, emits, key_width,
            keys.data_ptr(), valid.data_ptr(), per_line.data_ptr(),
            *delim_words(), torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"tokenizer kernel launch failed: cudaError {rc}")
    tokenize_block_kernel.launches += 1
    return keys, valid, per_line.sum(dtype=torch.int32)


tokenize_block_kernel.launches = 0
