"""Roofline accounting of the fold on the H100.

Two counts of the bytes a run moves, kept apart:

* **The least bytes** (``*_min_bytes``): each input of a kernel or of a
  fold read once and each output written once.  No implementation can
  move fewer, so time over these bytes can never read above the card's
  peak.  ``chip_smoke.py`` computes every kernel's ``bound_ms`` from
  them, and ``summarize`` takes ``hbm_utilization_pct`` from them.
* **The JAX package's traffic model** (``sort_pass_count``,
  ``mode_row_bytes``, ``pipeline_sort_traffic``): a copy of
  ``locust_tpu/utils/roofline.py``, which charges every sort with the
  pass count of the TPU's ``lax.sort`` bitonic schedule and the Pallas
  kernels' tile and launch structure.  It gives the JAX package's numbers
  at the same configuration, so its constants are the TPU's (a 256-row
  tile of 128 lanes, at most 32 fused substages a launch, the MXU
  histogram's 512-lane grid), copied here and never read from the port's
  kernel-B constants, which describe the Hopper kernel's tile.  On the
  card, ``torch.sort`` is a radix sort of a few passes and kernel B sorts
  in shared memory, so this model overstates the port's traffic many
  times: ``summarize`` reports it as ``est_sort_traffic_*``, labelled as
  the TPU schedule, and never derives a utilisation from it.

Peak bandwidths are NVIDIA's data-sheet figures keyed by
``torch.cuda.get_device_name()``; an unknown device (the CPU included)
yields ``peak=None`` and no utilisation.
"""

from __future__ import annotations

import math

from locust_tpu_torch.config import (
    FUSED_RESIDUAL_ROWS,
    FUSED_TABLE_SLOTS,
    FUSED_TILE_LINES,
    HASHT_PROBES,
    fused_stream_seg_blocks,
)
from locust_tpu_torch.ops.kernels.sort import padded_size

# Data-sheet HBM bandwidth, GB/s, keyed by torch.cuda.get_device_name().
PEAK_HBM_GB_S: dict[str, float] = {
    "NVIDIA H100 80GB HBM3": 3350.0,  # H100 SXM data sheet
}

# --- the JAX model's TPU constants (locust_tpu/config.py) ---
TPU_BITONIC_TILE_ROWS = 256   # BITONIC_TILE_ROWS, rows of 128 lanes
TPU_BITONIC_MAX_FUSED = 32    # BITONIC_MAX_FUSED
TPU_HASHT_MXU_LANES = 512     # HASHT_MXU_LANES
TPU_HASHT_MXU_CHUNK = 32768   # HASHT_MXU_CHUNK
TPU_FUSED_RESID_PAD = 8       # FUSED_RESID_PAD: f32 lanes past the key bytes
TPU_FUSED_SUBLANE = 8         # FUSED_SUBLANE

# Sort-operand structure per Process-stage mode, as the JAX model has it:
# (key_operands_u32, payload_operands_u32 (None: the whole row), gathers
# the full row at the end).
_MODE_OPERANDS = {
    "hash": (4, 0, True),
    "hashp": (3, None, False),
    "hashp2": (2, None, False),
    "hashp1": (1, None, False),
    "hasht": (1, None, False),
    "hasht-mxu": (1, None, False),
    "fused": (1, None, False),
    "hash1": (2, 0, True),
    "radix": (2, 0, True),
    "bitonic": (1, None, False),
    "lex": (None, 1, False),
}

_RADIX_PASSES = 4  # ceil(32 key bits / 8-bit digits)


def _pack_local_stages(specs, max_fused):
    """Split tile-local stage specs ``(s, t_hi, t_lo)`` into launches of at
    most ``max_fused`` substages each (greedy, order-preserving)."""
    launches, cur, cnt = [], [], 0
    for s, t_hi, t_lo in specs:
        t = t_hi
        while t >= t_lo:
            if cnt == max_fused:
                launches.append(tuple(cur))
                cur, cnt = [], 0
            take = min(max_fused - cnt, t - t_lo + 1)
            cur.append((s, t, t - take + 1))
            cnt += take
            t -= take
    if cur:
        launches.append(tuple(cur))
    return launches


def tpu_bitonic_schedule(kbits: int, m: int, max_fused: int = TPU_BITONIC_MAX_FUSED):
    """The Pallas bitonic sort's HBM passes for ``2^kbits`` elements and a
    tile of ``2^m``: ``("local", stages)`` launches and ``("cross", s, t)``
    passes in order (``locust_tpu/config.py`` ``bitonic_schedule``)."""
    mf = max_fused if max_fused > 0 else 1 << 30
    sched = []
    for ch in _pack_local_stages([(s, s, 1) for s in range(1, min(kbits, m) + 1)], mf):
        sched.append(("local", ch))
    for s in range(m + 1, kbits + 1):
        for t in range(s, m, -1):
            sched.append(("cross", s, t))
        for ch in _pack_local_stages([(s, m, 1)], mf):
            sched.append(("local", ch))
    return sched


def tpu_hasht_mxu_grid(table_size: int) -> tuple[int, int]:
    """[t_hi, t_lo] of the JAX MXU histogram over ``table_size`` slots."""
    t_lo = min(TPU_HASHT_MXU_LANES, table_size)
    return -(-table_size // t_lo), t_lo


def tpu_fused_table_layout() -> tuple[int, int]:
    """[t_hi, t_lo] planes of the JAX fused kernel's table: 512-lane rows,
    the hi axis padded to the sublane tile."""
    t_lo = min(512, FUSED_TABLE_SLOTS)
    return max(TPU_FUSED_SUBLANE, FUSED_TABLE_SLOTS // t_lo), t_lo


def _tpu_bitonic_tile_bits() -> int:
    return (TPU_BITONIC_TILE_ROWS * 128).bit_length() - 1


def _row_u32(key_lanes: int) -> int:
    """uint32 lanes of a full KV row: key lanes + value."""
    return key_lanes + 1


# ------------------------------------------------- the least bytes moved


def table_row_bytes(key_lanes: int) -> int:
    """Bytes of one table row: key lanes, int32 value, bool valid."""
    return 4 * key_lanes + 4 + 1


def tokenize_min_bytes(lines: int, width: int, emits: int, key_width: int) -> int:
    """Kernel A: the ``[lines, width]`` block in; ``[lines*emits, key_width]``
    keys, the valid bytes and the int32 overflow total out."""
    return lines * width + lines * emits * key_width + lines * emits + 4


def tokenize_min_ops(lines: int, width: int) -> int:
    """Kernel A's operations: one delimiter test per input byte."""
    return lines * width


def bitonic_min_bytes(n: int, payload_cols: int) -> int:
    """Kernel B: ``n`` int32 keys and ``[n, payload_cols]`` int32 rows in,
    the same out, sorted."""
    return 2 * n * 4 * (1 + payload_cols)


def bitonic_min_ops(n: int) -> int:
    """Kernel B's compare-exchanges: ``P/2`` per substage, ``k(k+1)/2``
    substages of Batcher's network over the padded size ``P = 2^k``."""
    p = padded_size(n)
    k = p.bit_length() - 1
    return (p // 2) * k * (k + 1) // 2


def fused_min_bytes(lines: int, width: int, key_width: int,
                    tile_lines: int = FUSED_TILE_LINES,
                    table_slots: int = FUSED_TABLE_SLOTS,
                    resid_rows: int = FUSED_RESIDUAL_ROWS) -> int:
    """Kernel C over ``lines`` lines (a block, or a ``run_stream`` segment):
    the lines in; every table and residual row (key bytes, int32 count,
    valid byte), the int32 overflow and the flag byte out."""
    rows = table_slots + -(-lines // tile_lines) * resid_rows
    return lines * width + rows * (key_width + 5) + 5


def fused_min_ops(lines: int, width: int) -> int:
    """Kernel C's operations: one delimiter test per input byte."""
    return lines * width


def pagerank_gather_min_bytes(num_nodes: int, num_edges: int, index_bytes: int = 8,
                              num_src: int | None = None, weighted: bool = True) -> int:
    """PageRank's ordered gather-add (``csrc/pagerank.cu``): the initial
    value, the CSR offsets and sources (``index_bytes=4`` for the int32
    indices the kernel takes below 2^31 nodes and edges, 8 for int64),
    the float32 ranks of the ``num_src`` sources (``num_nodes`` by
    default) and, for a ``weighted`` sum, their inverse degrees in, once
    each; the float32 totals of the ``num_nodes`` rows out.  The node
    schedule is the kernel's layout, not the function's work, and is not
    counted."""
    src = num_nodes if num_src is None else num_src
    per_src = 8 if weighted else 4
    return 4 + index_bytes * (num_nodes + 1 + num_edges) + per_src * src + 4 * num_nodes


def pagerank_gather_min_ops(num_edges: int, weighted: bool = True) -> int:
    """Its operations: one float32 add per edge, and for a ``weighted``
    sum one multiply."""
    return (2 if weighted else 1) * num_edges


def partition_min_bytes(rows: int, key_lanes: int, n_bins: int, bin_capacity: int,
                        leftover_capacity: int = 0, payload_bytes: int = 0,
                        bucket_bytes: int = 8) -> int:
    """The shuffle's stable counting partition (``csrc/partition.cu``): each
    row's bucket and valid byte read twice (its bin is counted before its
    rank is known), its lanes, value and ``payload_bytes`` read once;
    every output row written once as ``key_lanes + 2`` int32 words (the
    bins' and the leftover's, empty slots included) and each row's
    payload written once into its slot (an empty slot's payload is not
    written).  Rows that land nowhere are counted as landing: the bound
    of a partition whose valid rows all fit."""
    per_row_in = 2 * (bucket_bytes + 1) + 4 * key_lanes + 4 + payload_bytes
    slots = n_bins * bin_capacity + leftover_capacity
    return rows * per_row_in + slots * 4 * (key_lanes + 2) + rows * payload_bytes


# Cycles from one float32 add to the next that depends on it (Hopper's
# FP32 pipe latency).
FADD_DEPENDENT_CYCLES = 4


def pagerank_chain_min_ms(max_in_degree: int, sm_clock_mhz: float) -> float:
    """The gather-add's second bound: a row's adds are one dependent chain
    (the CPU's left fold in float32; partial sums merged afterwards would
    round differently), so the longest row takes its in-degree times a
    dependent add's latency at the SM clock, whatever runs beside it."""
    return max_in_degree * FADD_DEPENDENT_CYCLES / (sm_clock_mhz * 1e3)


def fold_min_bytes(key_lanes: int, table_size: int, n_blocks: int, block_lines: int,
                   line_width: int, n_folds: int | None = None) -> int:
    """A run's folds: every block's lines read once, and per fold the
    accumulator table read once and written once.  ``n_folds`` is the
    number of folds (default one per block; ``run_stream`` under
    ``fused`` folds once per segment)."""
    folds = n_blocks if n_folds is None else n_folds
    return n_blocks * block_lines * line_width + 2 * folds * table_size * table_row_bytes(key_lanes)


# --------------------------------------------- the JAX traffic model (TPU)


def sort_pass_count(n_rows: int, mode: str = "hash") -> int:
    """Data-streaming passes one sort of ``n_rows`` makes over its
    operands, in the JAX model (the TPU's schedule)."""
    if n_rows <= 1:
        return 0
    if mode == "radix":
        return _RADIX_PASSES
    if mode in ("hasht", "fused"):
        return 2 * HASHT_PROBES
    if mode == "hasht-mxu":
        return HASHT_PROBES
    k = math.ceil(math.log2(n_rows))
    if mode == "bitonic":
        return len(tpu_bitonic_schedule(k, min(k, _tpu_bitonic_tile_bits())))
    return k * (k + 1) // 2


def mode_row_bytes(mode: str, key_lanes: int) -> tuple[int, int]:
    """(bytes carried per row per sort pass, bytes moved once by gather)."""
    key_ops, payload_ops, gathers = _MODE_OPERANDS[mode]
    if key_ops is None:  # lex: every key lane is a sort key
        key_ops = key_lanes + 1
    if payload_ops is None:  # payload modes carry the whole row
        payload_ops = _row_u32(key_lanes)
    per_pass = 4 * (key_ops + payload_ops)
    gather = 2 * 4 * _row_u32(key_lanes) if gathers else 0
    return per_pass, gather


def pipeline_sort_traffic(sort_mode: str, key_lanes: int, emits_per_block: int,
                          table_size: int, n_blocks: int, block_lines: int | None = None,
                          line_width: int | None = None, fused_variant: str = "batch",
                          stream_seg_blocks: int | None = None) -> dict:
    """The JAX model's estimated bytes of the fold's sorts, end to end:
    one sort of ``table_size + emits_per_block`` rows per block; under
    ``fused``, the kernel's own bytes plus the hasht settlement over the
    pre-aggregated rows, per block (``"batch"``), per segment of
    ``stream_seg_blocks`` (``"stream"``) or per shard-block (``"mesh"``).
    The same numbers as ``locust_tpu.utils.roofline`` at the same
    configuration."""
    if sort_mode == "fused":
        if fused_variant not in ("batch", "stream", "mesh"):
            raise ValueError(f"fused_variant must be batch/stream/mesh, got {fused_variant!r}")
        if block_lines is None or line_width is None:
            raise ValueError(
                "fused roofline needs block_lines and line_width (the kernel's HBM bytes "
                "are sized off the line block, not the emit count)")
        t_hi, t_lo = tpu_fused_table_layout()
        n_tiles = -(-block_lines // FUSED_TILE_LINES)
        key_w = 4 * key_lanes
        resid_rows = n_tiles * FUSED_RESIDUAL_ROWS
        line_bytes = block_lines * line_width
        resid_bytes = 2 * resid_rows * (key_w + TPU_FUSED_RESID_PAD) * 4
        flush_bytes = 2 * (key_w + 2) * t_hi * t_lo * 4
        per_pass, gather = mode_row_bytes("hasht", key_lanes)
        out = {"sort_mode": sort_mode, "n_blocks": n_blocks, "fused_grid": [t_hi, t_lo],
               "fused_variant": fused_variant}
        if fused_variant == "stream":
            if stream_seg_blocks is None:
                stream_seg_blocks = fused_stream_seg_blocks(emits_per_block, block_lines,
                                                            on_device=True)
            seg = max(1, int(stream_seg_blocks))
            n_segments = -(-n_blocks // seg)
            settle_rows = table_size + t_hi * t_lo + seg * resid_rows
            passes = sort_pass_count(settle_rows, "fused")
            per_segment = (seg * (line_bytes + resid_bytes) + flush_bytes
                           + settle_rows * (2 * per_pass * passes + gather))
            out.update(
                rows_per_sort=settle_rows,
                sort_passes=passes,
                stream_seg_blocks=seg,
                n_segments=n_segments,
                est_kernel_bytes=int(n_segments * (seg * (line_bytes + resid_bytes)
                                                   + flush_bytes)),
                est_sort_traffic_bytes=int(n_segments * per_segment),
            )
            return out
        kernel_bytes = line_bytes + flush_bytes + resid_bytes
        if fused_variant == "mesh":
            rows = t_hi * t_lo + resid_rows
        else:  # batch: the per-block acc -> settle -> acc model
            rows = table_size + t_hi * t_lo + resid_rows
        passes = sort_pass_count(rows, "fused")
        per_block = kernel_bytes + rows * (2 * per_pass * passes + gather)
        out.update(
            rows_per_sort=rows,
            sort_passes=passes,
            est_kernel_bytes=int(n_blocks * kernel_bytes),
            est_sort_traffic_bytes=int(n_blocks * per_block),
        )
        return out
    per_pass, gather = mode_row_bytes(sort_mode, key_lanes)
    n_rows = table_size + emits_per_block
    passes = sort_pass_count(n_rows, sort_mode)
    per_block = n_rows * (2 * per_pass * passes + gather)
    out = {"sort_mode": sort_mode, "rows_per_sort": n_rows, "sort_passes": passes,
           "n_blocks": n_blocks}
    if sort_mode == "hasht-mxu":
        t_hi, t_lo = tpu_hasht_mxu_grid(table_size)
        n_chunks = max(1, -(-n_rows // TPU_HASHT_MXU_CHUNK))
        onehot = HASHT_PROBES * (n_rows * 2 * 2 * (5 * t_hi + t_lo)
                                 + n_chunks * 4 * 5 * t_hi * t_lo)
        per_block += onehot
        out["est_onehot_bytes"] = int(n_blocks * onehot)
        out["mxu_grid"] = [t_hi, t_lo]
    out["est_sort_traffic_bytes"] = int(n_blocks * per_block)
    return out


def summarize(sort_mode: str, key_lanes: int, emits_per_block: int, table_size: int,
              n_blocks: int, elapsed_s: float, device_kind: str | None,
              block_lines: int | None = None, line_width: int | None = None,
              fused_variant: str = "batch", stream_seg_blocks: int | None = None) -> dict:
    """The roofline row of one run: the JAX model's fields (the TPU
    schedule's estimated sort traffic, labelled so), and the least bytes
    of the run's folds (``fold_min_bytes``) over ``elapsed_s`` against the
    card's data-sheet peak as ``hbm_utilization_pct``.  Raises when that
    reads above 100%, which no real run can."""
    out = pipeline_sort_traffic(
        sort_mode, key_lanes, emits_per_block, table_size, n_blocks,
        block_lines=block_lines, line_width=line_width,
        fused_variant=fused_variant, stream_seg_blocks=stream_seg_blocks,
    )
    gb = out["est_sort_traffic_bytes"] / 1e9
    achieved = gb / elapsed_s if elapsed_s > 0 else 0.0
    out["est_sort_traffic_gb"] = round(gb, 3)
    out["achieved_sort_gb_s"] = round(achieved, 2)
    out["est_sort_traffic_model"] = (
        "the TPU's lax.sort bitonic schedule (the JAX package's model), not the port's traffic")
    out["device_kind"] = device_kind
    if block_lines is None or line_width is None:
        out["min_bytes"] = None
        out["achieved_min_gb_s"] = None
    else:
        folds = out.get("n_segments") if sort_mode == "fused" else None
        mb = fold_min_bytes(key_lanes, table_size, n_blocks, block_lines, line_width, folds)
        out["min_bytes"] = mb
        out["achieved_min_gb_s"] = round(mb / 1e9 / elapsed_s, 2) if elapsed_s > 0 else 0.0
    peak = PEAK_HBM_GB_S.get(device_kind or "")
    out["hbm_peak_gb_s"] = peak
    util = None
    if peak and out["achieved_min_gb_s"] is not None:
        util = round(100.0 * out["achieved_min_gb_s"] / peak, 2)
        if util > 100.0:
            raise ValueError(f"{sort_mode}: {util}% of the {device_kind} peak from "
                             f"{out['min_bytes']} bytes in {elapsed_s} s is impossible")
    out["hbm_utilization_pct"] = util
    out["model"] = ("hbm_utilization_pct: the folds' least bytes (each input read once, each "
                    "output written once) over the data-sheet peak; see utils/roofline.py")
    return out
