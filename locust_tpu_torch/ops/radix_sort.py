"""LSD radix argsort as torch ops: the ``"radix"`` Process-stage sort.

Port of ``locust_tpu/ops/radix_sort.py`` (XLA code there, not a Pallas
kernel, so plain torch is its port).  Per ``2^bits``-bucket stable
counting pass, least significant digit first:

  * digits            d[i]    = (key[i] >> shift) & (B-1)
  * stable rank       r[i]    = |{j < i : d[j] == d[i]}|
  * bucket bases      base[b] = exclusive sum of the digit histogram
  * scatter           out[base[d[i]] + r[i]] = in[i]

Ranks and histograms come from a chunked one-hot cumulative sum
(``[chunks, chunk, B]``).  The JAX package accumulates in uint16; CUDA
torch has no uint16 ``cumsum``, so the port counts in int32 (about 151 MB
of one-hot per pass at the fold's 147,456 rows) and keeps the JAX
argument checks, so both packages accept the same arguments.  Every pass
is stable, so the permutation is fully determined and equals JAX's
element for element.
"""

from __future__ import annotations

import torch

from locust_tpu_torch.core.packing import MASK32, to_u32


def radix_argsort(
    key: torch.Tensor, bits: int = 8, chunk: int = 8192, key_bits: int = 32
) -> torch.Tensor:
    """Stable ascending argsort of a 32-bit key (an int32 tensor holding
    the unsigned bit pattern) by LSD counting passes.

    Returns an int64 permutation ``sidx`` with ``key[sidx]`` sorted as
    unsigned values and equal keys in their original order.  ``bits`` is
    the digit width, ``chunk`` the row block of the rank cumsum,
    ``key_bits`` how many low bits of the key take part."""
    if key.dtype != torch.int32:
        raise TypeError(f"radix_argsort expects int32 (uint32 bit pattern) keys, got {key.dtype}")
    n = key.shape[0]
    n_buckets = 1 << bits
    if n_buckets > 65536 or chunk >= 65536:
        # The JAX package's uint16 rank bound, kept so both refuse alike.
        raise ValueError(f"bits={bits}/chunk={chunk} overflow uint16 ranks")
    n_passes = -(-key_bits // bits)
    dev = key.device

    # Pad to a chunk multiple with the max key: stability puts pad rows
    # after every real row of the same key, so perm[:n] is the real rows'.
    n_pad = -(-n // chunk) * chunk
    k = torch.full((n_pad,), MASK32, dtype=torch.int64, device=dev)
    k[:n] = to_u32(key)
    perm = torch.arange(n_pad, dtype=torch.int64, device=dev)
    n_chunks = n_pad // chunk
    crange = torch.arange(n_chunks, device=dev)[:, None]
    buckets = torch.arange(n_buckets, dtype=torch.int64, device=dev)

    for p in range(n_passes):
        d = ((k >> (p * bits)) & (n_buckets - 1)).reshape(n_chunks, chunk)
        oh = (d[..., None] == buckets).to(torch.int32)               # [C, M, B]
        within = torch.cumsum(oh, dim=1, dtype=torch.int32) - oh     # exclusive
        rank = torch.gather(within, 2, d[..., None])[..., 0]
        del oh, within
        hist = torch.zeros((n_chunks, n_buckets), dtype=torch.int32, device=dev)
        hist.scatter_add_(1, d, torch.ones_like(d, dtype=torch.int32))
        chunk_base = torch.cumsum(hist, dim=0, dtype=torch.int32) - hist
        total = hist.sum(dim=0, dtype=torch.int32)
        digit_base = torch.cumsum(total, dim=0, dtype=torch.int32) - total
        pos = (digit_base[d] + chunk_base[crange, d] + rank).reshape(n_pad).long()
        perm = torch.empty_like(perm).index_put_((pos,), perm)
        k = torch.empty_like(k).index_put_((pos,), k)
    return perm[:n]
