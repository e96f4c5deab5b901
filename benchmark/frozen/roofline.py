"""The least bytes a kernel call moves, and the card's peak bandwidth.

Frozen copy of ``locust_tpu_torch/utils/roofline.py`` (``PEAK_HBM_GB_S``,
``tokenize_min_bytes``, ``bitonic_min_bytes``, ``fused_min_bytes``,
``pagerank_gather_min_bytes``), with the fused kernel's tile, table and
residual sizes copied from ``locust_tpu_torch/config.py`` at their
defaults.  Each input is read once and each output written once, so a
kernel's time over these bytes can never read above the peak.
"""

from __future__ import annotations

# Data-sheet HBM bandwidth, bytes/s, keyed by torch.cuda.get_device_name().
PEAK_HBM_BYTES_S: dict[str, float] = {
    "NVIDIA H100 80GB HBM3": 3350e9,  # H100 SXM data sheet
}

FUSED_TILE_LINES = 32
FUSED_TABLE_SLOTS = 8192
FUSED_RESIDUAL_ROWS = 32


def peak_bytes_s(device_name: str | None) -> float | None:
    return PEAK_HBM_BYTES_S.get(device_name or "")


def tokenize_min_bytes(lines: int, width: int, emits: int, key_width: int) -> int:
    """Kernel A: the ``[lines, width]`` block in; ``[lines*emits, key_width]``
    keys, the valid bytes and the int32 overflow total out."""
    return lines * width + lines * emits * key_width + lines * emits + 4


def bitonic_min_bytes(n: int, payload_cols: int) -> int:
    """Kernel B: ``n`` int32 keys and ``[n, payload_cols]`` int32 rows in,
    the same out, sorted."""
    return 2 * n * 4 * (1 + payload_cols)


def fused_min_bytes(lines: int, width: int, key_width: int,
                    tile_lines: int = FUSED_TILE_LINES,
                    table_slots: int = FUSED_TABLE_SLOTS,
                    resid_rows: int = FUSED_RESIDUAL_ROWS) -> int:
    """Kernel C over ``lines`` lines: the lines in; every table and
    residual row (key bytes, int32 count, valid byte), the int32 overflow
    and the flag byte out."""
    rows = table_slots + -(-lines // tile_lines) * resid_rows
    return lines * width + rows * (key_width + 5) + 5


def pagerank_gather_min_bytes(num_nodes: int, num_edges: int, index_bytes: int = 8,
                              num_src: int | None = None, weighted: bool = True) -> int:
    """PageRank's ordered gather-add: the initial value, the CSR offsets
    and sources, the float32 ranks of the sources and, weighted, their
    inverse degrees in; the float32 totals of the rows out."""
    src = num_nodes if num_src is None else num_src
    per_src = 8 if weighted else 4
    return 4 + index_bytes * (num_nodes + 1 + num_edges) + per_src * src + 4 * num_nodes


def roofline_pct(least_bytes: int, seconds_per_call: float, device_name: str | None) -> float | None:
    """The share of the bandwidth bound a call reaches: the least time
    the card could take over the time it took, in percent; None on a card
    with no peak in the table."""
    peak = peak_bytes_s(device_name)
    if peak is None or seconds_per_call <= 0:
        return None
    return 100.0 * (least_bytes / peak) / seconds_per_call
