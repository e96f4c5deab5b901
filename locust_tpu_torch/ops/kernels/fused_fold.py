"""Kernel C: the fused map->aggregate kernel (``csrc/fused_fold.cu``), its
plain PyTorch version, and the engines' eligibility checks (one device,
and per shard of a mesh: ``fused_mesh_eligible``).

Replaces ``locust_tpu/ops/pallas/fused_fold.py`` (``_fused_kernel`` via
``fused_block_preagg``).  Same contract (fused_fold.py:36-68, :485-505):
for one ``[L, W]`` uint8 block, L a multiple of the tile, the rows of the
returned table and residual hold exactly the block's distinct keys with
exact totals; the overflow is the tokenizer's count of dropped tokens;
the flag says some tile stranded more keys than its residual rows hold,
and the caller must then re-fold the block through the stock path.  The
table has ``table_slots`` rows and the residual ``n_tiles * resid_rows``
rows.  Where the keys sit is free: the settlement
(``hash_table.aggregate_exact``) depends only on the keys and their
totals.  The kernel's design note is in its source.

``fused_block_preagg`` launches the CUDA kernel for a CUDA tensor (and
counts it in ``fused_block_preagg.launches``) and takes the plain version,
``fused_preagg_reference``, only for a CPU tensor.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from locust_tpu_torch import _build
from locust_tpu_torch.config import (
    FUSED_RESIDUAL_ROWS,
    FUSED_TABLE_SLOTS,
    FUSED_TILE_LINES,
    HASHT_PROBES,
    EngineConfig,
)
from locust_tpu_torch.core import packing
from locust_tpu_torch.core.kv import KVBatch
from locust_tpu_torch.ops.hash_table import hash_aggregate
from locust_tpu_torch.ops.kernels import KernelLaunchError
from locust_tpu_torch.ops.kernels.tokenize import (
    delim_words,
    device_guard,
    line_geometry,
    stream_handle,
    tokenize_reference,
)
from locust_tpu_torch.ops.map_stage import wordcount_map


def fused_engine_eligible(cfg: EngineConfig, map_fn, combine: str) -> tuple[bool, str]:
    """Can the single-device engine fold through the fused kernel?

    Returns ``(ok, reason)``; the checks are static, as in the JAX
    package: the kernel bakes in the wordcount tokenizer and the sum
    monoid ("count" lowers to emit-1 + sum); the block is a whole number
    of tiles; the line width is a multiple of 128 and a block has fewer
    than 2^24 emits.  The CUDA kernel needs neither of the last two (it
    takes any width up to its bound and counts in int32): they are the
    JAX kernel's gates, kept so that both packages engage the kernel, and
    report ``fused_demoted``, on the same configurations.  The JAX
    package's off-TPU interpret-mode cap is not a gate here: the CUDA
    kernel runs at any block size.
    """
    if map_fn is not wordcount_map:
        return False, (
            "map_fn is not the wordcount tokenizer (the kernel bakes "
            "tokenize+count in); folding exactly like 'hasht'"
        )
    if combine not in ("sum", "count"):
        return False, (
            f"combine={combine!r} has no kernel spelling (sum/count only); "
            "folding exactly like 'hasht'"
        )
    if cfg.block_lines % FUSED_TILE_LINES != 0:
        return False, (
            f"block_lines={cfg.block_lines} not a multiple of the "
            f"{FUSED_TILE_LINES}-line kernel tile; folding exactly like "
            "'hasht'"
        )
    if cfg.line_width % 128 != 0:
        return False, (
            f"line_width={cfg.line_width} not a multiple of 128 (the JAX "
            "package's kernel gate, kept for parity); folding exactly like "
            "'hasht'"
        )
    if cfg.emits_per_block >= 1 << 24:
        return False, (
            f"emits_per_block={cfg.emits_per_block} >= 2^24 (the JAX "
            "package's f32 count bound, kept for parity); folding exactly "
            "like 'hasht'"
        )
    return True, ""


def fused_mesh_eligible(cfg: EngineConfig, map_fn, combine: str, device) -> tuple[bool, str]:
    """Can the mesh engines run a shard's map and local combine through
    the fused kernel?  Returns ``(ok, reason)``, decided once when an
    engine is built (parallel/shuffle.py logs a demotion there and sets
    ``fused_demoted`` on its results):

    * every check of ``fused_engine_eligible`` applies per shard (a shard
      folds ``cfg.block_lines`` lines a round, the kernel's block);
    * the kernel runs on a CUDA rank; a CPU rank folds exactly like
      "hasht", as the JAX package does off the TPU, so the two packages
      demote on the same CPU runs;
    * the kernel's rows (table slots, laid out as the JAX kernel's padded
      planes, plus each tile's residual rows) fit the shard's
      ``emits_per_block`` rows: the shuffle step's local combiner returns
      as many rows as the block has emits, and the kernel's output is
      padded up to that.
    """
    ok, why = fused_engine_eligible(cfg, map_fn, combine)
    if not ok:
        return False, why
    if torch.device(device).type != "cuda":
        return False, (
            "mesh fused mode runs the CUDA kernel on a CUDA rank only (a "
            "CPU rank folds as the JAX package's CPU mesh does); folding "
            "exactly like 'hasht'"
        )
    t_lo = min(512, FUSED_TABLE_SLOTS)
    preagg_rows = max(8, FUSED_TABLE_SLOTS // t_lo) * t_lo \
        + cfg.block_lines // FUSED_TILE_LINES * FUSED_RESIDUAL_ROWS
    if preagg_rows > cfg.emits_per_block:
        return False, (
            f"kernel output ({preagg_rows} table+residual rows) exceeds "
            f"the shard's emit capacity ({cfg.emits_per_block}); folding "
            "exactly like 'hasht'"
        )
    return True, ""


def _params(lines, table_slots, resid_rows, probes, tile_lines):
    """Resolve the defaults and validate the block as the JAX wrapper
    does (its width rule included, for parity); returns ``(tile, slots,
    resid_rows, probes)``."""
    num_lines, width = lines.shape
    tile = FUSED_TILE_LINES if tile_lines is None else tile_lines
    slots = FUSED_TABLE_SLOTS if table_slots is None else table_slots
    r_cap = FUSED_RESIDUAL_ROWS if resid_rows is None else resid_rows
    n_probes = HASHT_PROBES if probes is None else probes
    if num_lines % tile != 0:
        raise ValueError(f"block_lines must be a multiple of {tile}")
    if width % 128 != 0:
        raise ValueError(f"line_width must be a multiple of 128, got {width}")
    if slots < 2 or slots & (slots - 1):
        raise ValueError(f"table_slots must be a power of two, got {slots}")
    return tile, slots, r_cap, n_probes


def fused_preagg_reference(
    lines: torch.Tensor,
    cfg: EngineConfig,
    table_slots: int | None = None,
    resid_rows: int | None = None,
    probes: int | None = None,
    tile_lines: int | None = None,
):
    """Plain version of ``fused_block_preagg``, same contract and shapes:
    ``tokenize_reference``; an exact dedupe per tile (``torch.unique``
    over (tile, key)); sequential probe rounds of every tile's keys over
    one ``slots``-slot table, the smallest folded hash winning a slot
    (``hash_aggregate``); the stranded keys of each tile in its residual
    rows, capped, and the flag when a tile strands more."""
    tile, slots, r_cap, n_probes = _params(lines, table_slots, resid_rows, probes, tile_lines)
    num_lines = lines.shape[0]
    n_tiles = num_lines // tile
    emits, n_lanes = cfg.emits_per_line, cfg.key_lanes
    dev = lines.device
    keys, valid, overflow = tokenize_reference(lines, emits, cfg.key_width)

    lanes = packing.pack_keys(keys).reshape(num_lines * emits, n_lanes)
    tile_of = torch.arange(num_lines * emits, device=dev) // (tile * emits)
    rows = torch.cat([tile_of[:, None], lanes.to(torch.int64)], dim=1)[valid.reshape(-1)]
    uniq, counts = torch.unique(rows, dim=0, return_counts=True)
    leader_tile = uniq[:, 0]
    leaders = KVBatch(
        key_lanes=uniq[:, 1:].to(torch.int32),
        values=counts.to(torch.int32),
        valid=torch.ones(uniq.shape[0], dtype=torch.bool, device=dev),
    )
    tab, _, unres = hash_aggregate(leaders, slots, "sum", probes=n_probes)

    # Rank each stranded leader within its tile; rows past r_cap go to a
    # dump row and raise the flag.
    stranded = unres.to(torch.int32)
    per_tile = torch.zeros(n_tiles, dtype=torch.int32, device=dev).index_add_(
        0, leader_tile, stranded
    )
    first = torch.cumsum(per_tile, 0, dtype=torch.int32) - per_tile
    rank = torch.cumsum(stranded, 0, dtype=torch.int32) - 1 - first[leader_tile]
    n_res = n_tiles * r_cap
    dest = (torch.where(unres & (rank < r_cap), leader_tile * r_cap + rank, n_res),)
    res_lanes = torch.zeros((n_res + 1, n_lanes), dtype=torch.int32, device=dev)
    res_lanes.index_put_(dest, leaders.key_lanes)
    res_count = torch.zeros((n_res + 1,), dtype=torch.int32, device=dev)
    res_count.index_put_(dest, leaders.values)

    tab_lanes = torch.where(tab.valid[:, None], tab.key_lanes, 0)
    table = KVBatch(tab_lanes, tab.values, tab.values > 0)
    resid = KVBatch(res_lanes[:n_res], res_count[:n_res], res_count[:n_res] > 0)
    return table, resid, overflow, (per_tile > r_cap).any()


@functools.cache
def _kernel() -> tuple:
    """The C entry point and the kernel's (max width, max emits), loaded
    and asked once."""
    lib = _build.load("fused_fold")
    p, i, ll, u64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_ulonglong
    fn = lib.locust_fused_preagg
    fn.argtypes = [p, ll, i, i, i, i, i, i, i, i, i, p, u64, u64, u64, u64, i, p]
    fn.restype = ctypes.c_int
    bounds = []
    for name in ("locust_fused_max_width", "locust_fused_max_emits"):
        getattr(lib, name).argtypes = []
        getattr(lib, name).restype = ctypes.c_int
        bounds.append(getattr(lib, name)())
    return fn, *bounds


def fused_block_preagg(
    lines: torch.Tensor,
    cfg: EngineConfig,
    table_slots: int | None = None,
    resid_rows: int | None = None,
    probes: int | None = None,
    tile_lines: int | None = None,
):
    """Pre-aggregate one ``[L, W]`` uint8 block.  Returns ``(table,
    residual, overflow, flag)``: KVBatches of ``table_slots`` and
    ``n_tiles * resid_rows`` rows, an int32 scalar and a bool scalar
    tensor (see the module docstring for the contract)."""
    tile, slots, r_cap, n_probes = _params(lines, table_slots, resid_rows, probes, tile_lines)
    if lines.device.type == "cpu":
        return fused_preagg_reference(lines, cfg, slots, r_cap, n_probes, tile)
    if lines.device.type != "cuda":
        raise ValueError(f"fused pre-aggregation: no kernel for device {lines.device}")
    if lines.dtype != torch.uint8 or lines.dim() != 2 or not lines.is_contiguous():
        raise ValueError("fused pre-aggregation: lines must be a contiguous uint8 [L, W] tensor")
    fn, max_width, max_emits = _kernel()
    num_lines, width = lines.shape
    emits, n_lanes = cfg.emits_per_line, cfg.key_lanes
    if width > max_width or emits > max_emits:
        raise ValueError(
            f"fused pre-aggregation: width {width} or emits {emits} above the "
            f"kernel's bounds ({max_width}, {max_emits})"
        )
    n_res = num_lines // tile * r_cap
    dev = lines.device
    # One buffer, every byte written by the kernel: the int32 table lanes,
    # counts, slot states, residual lanes, counts, overflow and flag word,
    # then the bool table valid, residual valid and flag.
    sizes = [slots * n_lanes, slots, slots, n_res * n_lanes, n_res, 1, 1]
    n_int = sum(sizes)
    out = torch.empty(4 * n_int + slots + n_res + 1, dtype=torch.uint8, device=dev)
    ints, bools = out.split([4 * n_int, slots + n_res + 1])
    tab_lanes, tab_count, _, res_lanes, res_count, overflow, _ = ints.view(torch.int32).split(sizes)
    tab_valid, res_valid, flag = bools.view(torch.bool).split([slots, n_res, 1])
    with device_guard(dev):
        rc = fn(
            lines.data_ptr(), num_lines, width, tile, emits, cfg.key_width, slots,
            n_probes, r_cap, *line_geometry(width), out.data_ptr(), *delim_words(),
            dev.index, stream_handle(dev),
        )
    if rc != 0:
        raise KernelLaunchError(f"fused pre-aggregation kernel launch failed: cudaError {rc}")
    fused_block_preagg.launches += 1
    table = KVBatch(tab_lanes.view(slots, n_lanes), tab_count, tab_valid)
    resid = KVBatch(res_lanes.view(n_res, n_lanes), res_count, res_valid)
    return table, resid, overflow[0], flag[0]


fused_block_preagg.launches = 0
