"""Kernel B: the bitonic sort (``csrc/bitonic.cu``) and its plain PyTorch
version.

Replaces ``locust_tpu/ops/pallas/sort.py`` (``_local_stages_kernel`` via
``_run_local``, entry ``bitonic_sort``).  Same contract as the JAX
``bitonic_sort``: an ascending sort of a 32-bit key viewed as unsigned
(here an int32 tensor holding the bit pattern), payloads moved alongside
(here as the columns of one int32 ``[n, P]`` tensor), not stable.  The key is padded to a power of two (at least 1024) with
0xFFFFFFFF.  Pad-sentinel caveat, as in the JAX kernel: a real row whose
key is 0xFFFFFFFF ties with the pad, and the first ``n`` rows may then
hold a pad row (zero payload) in its place; the engine's folded key
reserves 0xFFFFFFFF for invalid rows, whose payloads are dead.

A CUDA tensor launches the kernel (``bitonic_sort_rows.launches`` counts
whole sorts); a CPU tensor takes ``bitonic_reference``, a stable
``torch.sort`` of the widened key and a gather of the payload rows, which
is what the JAX package's own stand-in for the kernel (hashp1) computes.
"""

from __future__ import annotations

import ctypes

import torch

from locust_tpu_torch import _build
from locust_tpu_torch.config import BITONIC_TILE_BITS, bitonic_schedule
from locust_tpu_torch.core.packing import to_u32


def padded_size(n: int) -> int:
    """Power of two the sort pads ``n`` elements to (floor 1024)."""
    return max(1 << 10, 1 << max(n - 1, 1).bit_length())


def bitonic_reference(key: torch.Tensor, rows: torch.Tensor):
    """Plain version: stable ascending sort of the unsigned key, payload
    rows ``[n, P]`` gathered into the same order."""
    order = torch.sort(to_u32(key), stable=True).indices
    return key[order], rows[order]


def _lib() -> ctypes.CDLL:
    lib = _build.load("bitonic")
    if lib.locust_bitonic_local.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.locust_bitonic_local.argtypes = [
            p, p, p, ll, i, ll, ctypes.POINTER(ctypes.c_int), i, i, p,
        ]
        lib.locust_bitonic_cross.argtypes = [p, p, ll, i, i, p]
        lib.locust_bitonic_gather.argtypes = [p, p, p, ll, i, p, p, p]
        for fn in (lib.locust_bitonic_local, lib.locust_bitonic_cross,
                   lib.locust_bitonic_gather):
            fn.restype = ctypes.c_int
        for name in ("locust_bitonic_max_tile_bits", "locust_bitonic_max_stages"):
            getattr(lib, name).argtypes = []
            getattr(lib, name).restype = ctypes.c_int
    return lib


def _check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"bitonic {what} launch failed: cudaError {rc}")


def bitonic_sort_rows(key: torch.Tensor, rows: torch.Tensor):
    """Sort int32 ``key`` ``[n]`` (unsigned order) and move the int32
    payload ``rows`` ``[n, P]`` with it; returns ``(key, rows)`` sorted."""
    if key.dtype != torch.int32 or key.dim() != 1:
        raise TypeError(f"key must be an int32 [n] tensor, got {key.dtype} {tuple(key.shape)}")
    if rows.dtype != torch.int32 or rows.dim() != 2 or rows.shape[0] != key.shape[0]:
        raise TypeError("rows must be an int32 [n, P] tensor matching key")
    if key.device.type == "cpu":
        return bitonic_reference(key, rows)
    if key.device.type != "cuda":
        raise ValueError(f"bitonic sort: no kernel for device {key.device}")
    if not (key.is_contiguous() and rows.is_contiguous()) or rows.device != key.device:
        raise ValueError("bitonic sort: key and rows must be contiguous, on one device")
    lib = _lib()
    n, width = rows.shape
    n_pad = padded_size(n)
    kbits = n_pad.bit_length() - 1
    m = min(BITONIC_TILE_BITS, lib.locust_bitonic_max_tile_bits(), kbits)
    dev = key.device
    skey = torch.empty((n_pad,), dtype=torch.int32, device=dev)
    sidx = torch.empty((n_pad,), dtype=torch.int32, device=dev)
    out_key = torch.empty((n,), dtype=torch.int32, device=dev)
    out_rows = torch.empty((n, width), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        init = 1
        for step in bitonic_schedule(kbits, m):
            if step[0] == "local":
                flat = [v for triple in step[1] for v in triple]
                if len(step[1]) > lib.locust_bitonic_max_stages():
                    raise ValueError(f"bitonic sort: {len(step[1])} stages in one launch")
                stages = (ctypes.c_int * len(flat))(*flat)
                _check(lib.locust_bitonic_local(
                    skey.data_ptr(), sidx.data_ptr(), key.data_ptr(), n, m,
                    n_pad >> m, stages, len(step[1]), init, stream,
                ), "local")
                init = 0
            else:
                _check(lib.locust_bitonic_cross(
                    skey.data_ptr(), sidx.data_ptr(), n_pad, step[1], step[2], stream,
                ), "cross")
        _check(lib.locust_bitonic_gather(
            skey.data_ptr(), sidx.data_ptr(), rows.data_ptr(), n, width,
            out_key.data_ptr(), out_rows.data_ptr(), stream,
        ), "gather")
    bitonic_sort_rows.launches += 1
    return out_key, out_rows


bitonic_sort_rows.launches = 0
