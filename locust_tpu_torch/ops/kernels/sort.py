"""Kernel B: the bitonic sort (``csrc/bitonic.cu``) and its plain PyTorch
versions.

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
whole sorts, ``.cuda_launches`` the kernel launches of the last one); a
CPU tensor takes ``bitonic_reference``, a stable
``torch.sort`` of the widened key and a gather of the payload rows, which
is what the JAX package's own stand-in for the kernel (hashp1) computes.
``bitonic_network_reference`` runs Batcher's network itself and gives the
kernel's permutation; only tests and ``chip_smoke.py`` call it.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from locust_tpu_torch import _build
from locust_tpu_torch.config import BITONIC_TILE_BITS, bitonic_launch_plan
from locust_tpu_torch.core.packing import to_i32, to_u32


def padded_size(n: int) -> int:
    """Power of two the sort pads ``n`` elements to (floor 1024)."""
    return max(1 << 10, 1 << max(n - 1, 1).bit_length())


def tile_bits(kbits: int) -> int:
    """Tile of the kernel for ``2^kbits`` padded elements."""
    return min(BITONIC_TILE_BITS, kbits)


def bitonic_reference(key: torch.Tensor, rows: torch.Tensor):
    """Plain version: stable ascending sort of the unsigned key, payload
    rows ``[n, P]`` gathered into the same order."""
    order = torch.sort(to_u32(key), stable=True).indices
    return key[order], rows[order]


def bitonic_network_reference(key: torch.Tensor, rows: torch.Tensor):
    """Plain version of the kernel's permutation: Batcher's network over
    the key padded to ``padded_size(n)`` with 0xFFFFFFFF, one vectorised
    compare-exchange per substage, swapping only where the keys strictly
    differ.  Returns the first ``n`` keys and rows; a pad row that reaches
    them carries a zero payload, as in the kernel and the JAX kernel."""
    n = key.shape[0]
    n_pad = padded_size(n)
    kbits = n_pad.bit_length() - 1
    k = torch.full((n_pad,), 0xFFFFFFFF, dtype=torch.int64, device=key.device)
    k[:n] = to_u32(key)
    idx = torch.arange(n_pad, device=key.device)
    for s in range(1, kbits + 1):
        for t in range(s, 0, -1):
            d = 1 << (t - 1)
            kv, iv = k.view(-1, 2, d), idx.view(-1, 2, d)
            lo_start = torch.arange(0, n_pad, 2 * d, device=key.device)
            asc = (((lo_start >> s) & 1) == 0)[:, None]
            klo, khi = kv[:, 0], kv[:, 1]
            swap = torch.where(asc, khi < klo, khi > klo)
            k = torch.stack([torch.where(swap, khi, klo), torch.where(swap, klo, khi)], 1).view(-1)
            ilo, ihi = iv[:, 0], iv[:, 1]
            idx = torch.stack([torch.where(swap, ihi, ilo), torch.where(swap, ilo, ihi)], 1).view(-1)
    src = idx[:n]
    real = src < n
    out_rows = torch.where(real[:, None], rows[src.clamp(max=max(n - 1, 0))], 0)
    return to_i32(k[:n]), out_rows.to(rows.dtype)


def _lib() -> ctypes.CDLL:
    lib = _build.load("bitonic")
    if lib.locust_bitonic_sort.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.locust_bitonic_sort.argtypes = [
            p, p, p, p, p, ll, i, i, ctypes.POINTER(ctypes.c_int), i, p,
            ctypes.POINTER(ctypes.c_int),
        ]
        lib.locust_bitonic_sort.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _plan_array(kbits: int):
    """``bitonic_launch_plan(kbits, tile_bits(kbits))`` flattened into the
    C entry point's int array, built once per shape."""
    plan = bitonic_launch_plan(kbits, tile_bits(kbits))
    flat = []
    for block, low, cross_at, stages in plan:
        flat += [block, low, cross_at, len(stages)]
        flat += [v for triple in stages for v in triple]
    return (ctypes.c_int * len(flat))(*flat), len(plan)


def plan_steps(n: int) -> int:
    """Steps of the kernel's launch plan for ``n`` rows: its CUDA launches
    where the plan does not run as one cooperative launch."""
    kbits = padded_size(n).bit_length() - 1
    return len(bitonic_launch_plan(kbits, tile_bits(kbits)))


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
    kbits = padded_size(n).bit_length() - 1
    plan, steps = _plan_array(kbits)
    dev = key.device
    words = torch.empty((1 << kbits) if steps > 1 else 1, dtype=torch.int64, device=dev)
    out_key = torch.empty((n,), dtype=torch.int32, device=dev)
    out_rows = torch.empty((n, width), dtype=torch.int32, device=dev)
    launched = ctypes.c_int(0)
    with torch.cuda.device(dev):
        rc = lib.locust_bitonic_sort(
            words.data_ptr(), key.data_ptr(), rows.data_ptr(), out_key.data_ptr(),
            out_rows.data_ptr(), n, width, kbits, plan, steps,
            torch.cuda.current_stream(dev).cuda_stream, ctypes.byref(launched),
        )
    if rc != 0:
        raise RuntimeError(f"bitonic sort launch failed: cudaError {rc}")
    bitonic_sort_rows.launches += 1
    bitonic_sort_rows.cuda_launches = launched.value
    return out_key, out_rows


bitonic_sort_rows.launches = 0  # whole sorts
bitonic_sort_rows.cuda_launches = 0  # kernel launches of the last sort
