"""Key packing and key hashing on 32-bit lanes held as int32 bit patterns.

Port of ``locust_tpu/core/packing.py:25-131`` and of its
``lanes_geq_table`` (:78-87).  A ``key_width``-byte key packs into
``key_width / 4`` big-endian 32-bit lanes, so lane-tuple order is byte
order.  The JAX package keeps the lanes as uint32; torch on the
CPU has no uint32 shifts, adds, sums or compares, so the port carries the
same 32 bits in int32 tensors and does the unsigned arithmetic in int64,
masked to 32 bits after every step.  ``hash_pair`` is bit-identical to
the JAX one (tests/test_torch_core.py).
"""

from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF


def to_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 holding an unsigned 32-bit value -> the int32 tensor with the
    same bit pattern."""
    x = x & MASK32
    return torch.where(x >= 0x80000000, x - 0x100000000, x).to(torch.int32)


def to_u32(x: torch.Tensor) -> torch.Tensor:
    """int32 bit pattern -> int64 holding its unsigned value."""
    return x.to(torch.int64) & MASK32


def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """``(a * c) mod 2^32`` for ``a`` in [0, 2^32) held in int64: the
    constant is split in 16-bit halves so no product leaves int64."""
    lo = a * (c & 0xFFFF)
    hi = (a * (c >> 16)) & 0xFFFF
    return (lo + (hi << 16)) & MASK32


def pack_keys(keys: torch.Tensor) -> torch.Tensor:
    """uint8 ``[..., K]`` -> big-endian 32-bit lanes ``[..., K//4]`` (int32
    bit patterns)."""
    k = keys.shape[-1]
    if k % 4 != 0:
        raise ValueError(f"key width {k} not a multiple of 4")
    r = keys.reshape(*keys.shape[:-1], k // 4, 4).to(torch.int64)
    return to_i32((r[..., 0] << 24) | (r[..., 1] << 16) | (r[..., 2] << 8) | r[..., 3])


def unpack_keys(lanes: torch.Tensor) -> torch.Tensor:
    """Big-endian 32-bit lanes ``[..., L]`` -> uint8 bytes ``[..., 4L]``."""
    u = to_u32(lanes)
    parts = torch.stack(
        [(u >> 24) & 0xFF, (u >> 16) & 0xFF, (u >> 8) & 0xFF, u & 0xFF], dim=-1
    ).to(torch.uint8)
    return parts.reshape(*lanes.shape[:-1], lanes.shape[-1] * 4)


def _fmix32(h: torch.Tensor) -> torch.Tensor:
    """murmur3 finalizer on unsigned 32-bit values held in int64."""
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    h = h ^ (h >> 16)
    return h


def _salted_fold(lanes: torch.Tensor, salt_prime: int, pre_mul: int | None) -> torch.Tensor:
    """``fmix32(sum_i fmix32(lane_i ^ salt_i))`` over the last axis; takes
    and returns unsigned 32-bit values held in int64."""
    n_lanes = lanes.shape[-1]
    i = torch.arange(n_lanes, dtype=torch.int64, device=lanes.device)
    salts = _mul32(i + 1, salt_prime)
    x = lanes if pre_mul is None else _mul32(lanes, pre_mul)
    per_lane = _fmix32(x ^ salts)
    return _fmix32(per_lane.sum(dim=-1) & MASK32)


def primary_hash(lanes: torch.Tensor) -> torch.Tensor:
    """``hash_pair``'s first hash alone, as an unsigned value in int64 (the
    folded sort key needs only this one)."""
    return _salted_fold(to_u32(lanes), 0x9E3779B9, None)


def hash_pair(lanes: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Two independent 32-bit mixing hashes of packed key lanes (int32 bit
    patterns in, int32 bit patterns out)."""
    h2 = _salted_fold(to_u32(lanes), 0xC2B2AE3D, 0x01000193)
    return to_i32(primary_hash(lanes)), to_i32(h2)


def fold_hash(lanes: torch.Tensor) -> torch.Tensor:
    """The shuffle's bucketing hash of packed key lanes, a salt distinct
    from both ``hash_pair`` streams (the JAX ``fold_hash``); returns the
    unsigned 32-bit value held in int64."""
    return _salted_fold(to_u32(lanes), 0x85EBCA77, None)


def lanes_geq_table(keys: torch.Tensor, splitters: torch.Tensor) -> torch.Tensor:
    """Pairwise lexicographic ``keys[n] >= splitters[s]`` over big-endian
    lanes (int32 bit patterns, compared unsigned) -> bool ``[N, S]``: the
    range partition's comparator (the sample sort).  The first differing
    lane decides; equal keys are ``>=``."""
    a, b = torch.broadcast_tensors(to_u32(keys)[:, None, :], to_u32(splitters)[None, :, :])
    neq = a != b
    first = neq.to(torch.int8).argmax(dim=-1, keepdim=True)
    a_at, b_at = a.gather(-1, first)[..., 0], b.gather(-1, first)[..., 0]
    return torch.where(neq.any(dim=-1), a_at > b_at, True)
