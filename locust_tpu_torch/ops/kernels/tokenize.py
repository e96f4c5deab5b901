"""Kernel A: the Map-stage tokenizer (``csrc/tokenize.cu``) and its plain
PyTorch version.

Replaces ``locust_tpu/ops/pallas/tokenize.py`` (``_tokenize_kernel`` via
``tokenize_block_pallas``).  ``tokenize_block_kernel`` launches the CUDA
kernel for a CUDA tensor and takes the plain version, ``tokenize_reference``
(the "gather" formulation of ``locust_tpu/ops/map_stage.tokenize_block``),
only for a CPU tensor.  The kernel's design note is in its source.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools

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


@functools.cache
def delim_words() -> tuple[int, ...]:
    """The delimiter set as four 64-bit masks (bit b: byte b ends a token)."""
    words = [0, 0, 0, 0]
    for b in FULL_DELIMITERS:
        words[b >> 6] |= 1 << (b & 63)
    return tuple(words)


@functools.cache
def line_geometry(width: int) -> tuple[int, int]:
    """The kernels' line layout (``csrc/tokenize.cuh``): ``(g_log, chunks)``,
    a group of ``2**g_log`` lanes per line, each lane owning ``chunks``
    16-byte chunks, ``16 * chunks * 2**g_log >= width``."""
    lanes = 1
    while lanes < 32 and 16 * lanes < width:
        lanes *= 2
    return lanes.bit_length() - 1, -(-width // (16 * lanes))


@functools.cache
def _kernel() -> tuple:
    """The C entry point and the kernel's (max width, max emits), loaded
    and asked once."""
    lib = _build.load("tokenize")
    p, i, ll, u64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_ulonglong
    fn = lib.locust_tokenize
    fn.argtypes = [p, ll, i, i, i, i, i, p, p, p, p, u64, u64, u64, u64, p]
    fn.restype = ctypes.c_int
    bounds = []
    for name in ("locust_tokenize_max_width", "locust_tokenize_max_emits"):
        getattr(lib, name).argtypes = []
        getattr(lib, name).restype = ctypes.c_int
        bounds.append(getattr(lib, name)())
    return fn, *bounds


def device_guard(dev: torch.device):
    """Makes ``dev`` the current CUDA device for a launch, where it is not."""
    if dev.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(dev)


def stream_handle(dev: torch.device) -> int:
    """The handle of ``dev``'s current CUDA stream, as
    ``torch.cuda.current_stream(dev).cuda_stream`` gives it, without
    building a ``Stream`` object on every launch."""
    return torch._C._cuda_getCurrentRawStream(dev.index)


# The kernel's overflow scratch, 17 uint64 ticket words per (device,
# stream): zero before every launch and left zero by it, so a call needs
# no memset.
_scratch: dict[tuple[int, int], torch.Tensor] = {}


def tokenize_block_kernel(lines: torch.Tensor, emits: int, key_width: int):
    """Tokenize a ``[L, W]`` uint8 block: keys uint8 ``[L, E, K]``, valid
    bool ``[L, E]``, overflow int32 scalar.

    A CUDA tensor launches ``csrc/tokenize.cu``, one device op (``launches``
    counts the launches); a CPU tensor takes ``tokenize_reference``.
    """
    if lines.device.type == "cpu":
        return tokenize_reference(lines, emits, key_width)
    if lines.device.type != "cuda":
        raise ValueError(f"tokenizer: no kernel for device {lines.device}")
    if lines.dtype != torch.uint8 or lines.dim() != 2 or not lines.is_contiguous():
        raise ValueError("tokenizer: lines must be a contiguous uint8 [L, W] tensor")
    if key_width % 4 != 0:
        raise ValueError(f"tokenizer: key_width {key_width} not a multiple of 4")
    fn, max_width, max_emits = _kernel()
    num_lines, width = lines.shape
    if width > max_width or emits > max_emits:
        raise ValueError(
            f"tokenizer: width {width} or emits {emits} above the kernel's "
            f"bounds ({max_width}, {max_emits})"
        )
    dev = lines.device
    keys = torch.empty((num_lines, emits, key_width), dtype=torch.uint8, device=dev)
    valid = torch.empty((num_lines, emits), dtype=torch.bool, device=dev)
    total = torch.empty((), dtype=torch.int32, device=dev)
    with device_guard(dev):
        stream = stream_handle(dev)
        scratch = _scratch.get((dev.index, stream))
        if scratch is None:
            scratch = _scratch[dev.index, stream] = torch.zeros(17, dtype=torch.int64, device=dev)
        rc = fn(
            lines.data_ptr(), num_lines, width, emits, key_width, *line_geometry(width),
            keys.data_ptr(), valid.data_ptr(), total.data_ptr(), scratch.data_ptr(),
            *delim_words(), stream,
        )
    if rc != 0:
        raise RuntimeError(f"tokenizer kernel launch failed: cudaError {rc}")
    tokenize_block_kernel.launches += 1
    return keys, valid, total


tokenize_block_kernel.launches = 0
