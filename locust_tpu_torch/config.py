"""Runtime configuration of the PyTorch/CUDA engine.

The port's own copy of the JAX package's ``locust_tpu/config.py`` surface
that the single-device WordCount path needs: the delimiter sets, the sort
mode names, the bitonic launch plan, the hash-table fold and fused-kernel
knobs, and ``EngineConfig``.  ``EngineConfig`` keeps the JAX class's
fields, their order and their defaults, so that ``repr(cfg)`` and
``cfg.fingerprint()`` are equal in both packages (a checkpoint written by
one names the same configuration in the other).  The knobs read the same
environment variables, with the same defaults and validation.
"""

from __future__ import annotations

import dataclasses
import os

# Tokenization delimiter set, byte for byte the reference's strtok
# delimiters (reference MapReduce/src/main.cu:138).
DELIMITERS: bytes = b" ,.-;:'()\"\t"

# Process-stage sort strategies, named as in the JAX package.  The ported
# ones are ops/process_stage.PORTED_SORT_MODES; the rest raise
# NotImplementedError until their slice lands.
SORT_MODES = (
    "hash", "hashp", "hashp2", "hashp1", "hash1", "radix", "bitonic", "lex",
    "hasht", "hasht-mxu", "fused",
)

# The sort-free hash-table fold family (ops/hash_table.py): "hasht" combines
# by scatter, "hasht-mxu" by a one-hot matrix product, "fused" is hasht with
# each block pre-aggregated by the fused kernel (ops/kernels/fused_fold.py).
# The three give bit-identical tables.
HASHT_FAMILY = ("hasht", "hasht-mxu", "fused")

# Probe rounds of the hash-table fold before a row falls to the exact
# residual/sort ladder (ops/hash_table.aggregate_exact).
HASHT_PROBES: int = int(os.environ.get("LOCUST_HASHT_PROBES", 4))
if HASHT_PROBES < 1:
    raise ValueError(f"LOCUST_HASHT_PROBES must be >= 1, got {HASHT_PROBES}")

# --- fused map->aggregate kernel (ops/kernels/fused_fold.py) ---

# Lines per kernel tile (one CUDA thread block each).  A multiple of 32, as
# in the JAX package, so both packages accept the same configurations.
FUSED_TILE_LINES: int = int(os.environ.get("LOCUST_FUSED_TILE_LINES", 32))
if FUSED_TILE_LINES < 32 or FUSED_TILE_LINES % 32 != 0:
    raise ValueError(
        f"LOCUST_FUSED_TILE_LINES must be a positive multiple of 32, "
        f"got {FUSED_TILE_LINES}"
    )

# Slots of the per-block kernel table; a power of two so the probe's
# ``h % slots`` is a bitwise AND.  Keys past it strand to the residual.
FUSED_TABLE_SLOTS: int = int(os.environ.get("LOCUST_FUSED_TABLE_SLOTS", 8192))
if FUSED_TABLE_SLOTS < 512 or FUSED_TABLE_SLOTS & (FUSED_TABLE_SLOTS - 1):
    raise ValueError(
        f"LOCUST_FUSED_TABLE_SLOTS must be a power of two >= 512, "
        f"got {FUSED_TABLE_SLOTS}"
    )

# Residual rows per tile: distinct keys of a tile that every probe
# stranded.  More than this sets the kernel's flag, and the engine
# re-folds the block through the stock path.
FUSED_RESIDUAL_ROWS: int = int(
    os.environ.get("LOCUST_FUSED_RESIDUAL_ROWS", 32)
)
if FUSED_RESIDUAL_ROWS < 8 or FUSED_RESIDUAL_ROWS & (FUSED_RESIDUAL_ROWS - 1):
    raise ValueError(
        f"LOCUST_FUSED_RESIDUAL_ROWS must be a power of two >= 8, "
        f"got {FUSED_RESIDUAL_ROWS}"
    )

# Bytes that end a token on the device beyond the strtok set: NUL (row
# padding and embedded NULs) and the newline pair.
TOKEN_BOUNDARY_EXTRA: bytes = b"\x00\n\r"
FULL_DELIMITERS: bytes = DELIMITERS + TOKEN_BOUNDARY_EXTRA

# Bitonic sort tile of the CUDA kernel (ops/kernels/sort.py): 2^12
# elements of (uint32 key, uint32 row index) = 32 KB of shared memory per
# block, under the 48 KB a block gets without opting in.  Every substage
# whose compare distance is below the tile runs inside one block.
BITONIC_TILE_BITS: int = 12


def _pack_local_stages(specs, max_fused):
    """Split/merge tile-local stage specs ``(s, t_hi, t_lo)`` into launches
    of at most ``max_fused`` substages each (greedy, order-preserving;
    stages split mid-run when needed)."""
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


def bitonic_schedule(kbits: int, m: int, max_fused: int = 0):
    """Launch plan of the bitonic sort of ``n = 2^kbits`` elements with a
    tile of ``2^m``: ``("local", ((s, t_hi, t_lo), ...))`` launches that
    run tile-local substages back to back, and ``("cross", s, t)`` global
    passes, in execution order.  ``max_fused`` caps the substages of one
    local launch; 0 means no cap, which is what the CUDA kernel runs (the
    cap exists in the JAX package only to keep a TPU compile small)."""
    mf = max_fused if max_fused > 0 else 1 << 30
    sched = []
    local1 = [(s, s, 1) for s in range(1, min(kbits, m) + 1)]
    for ch in _pack_local_stages(local1, mf):
        sched.append(("local", ch))
    for s in range(m + 1, kbits + 1):
        for t in range(s, m, -1):
            sched.append(("cross", s, t))
        for ch in _pack_local_stages([(s, m, 1)], mf):
            sched.append(("local", ch))
    return sched


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Static shape/capacity configuration of one MapReduce pipeline.

    Same fields, order and defaults as the JAX package's ``EngineConfig``;
    the fields that only the JAX executor reads (``map_impl``,
    ``donate_fold``, ``async_checkpoint``, ``stream_staging_ring``,
    ``trace``) are kept so that ``repr`` and ``fingerprint`` agree.
    """

    # Max bytes per input line (reference KeyValue.h:9, rounded to 128).
    line_width: int = 128
    # Max bytes per emitted key (reference KeyValue.h:15, rounded to 32).
    key_width: int = 32
    # Max emits (tokens) per line (reference EMITS_PER_LINE, main.cu:19).
    emits_per_line: int = 20
    # Lines per processing block.
    block_lines: int = 4096
    # Accumulator table capacity; None resolves as resolved_table_size.
    table_size: int | None = None
    # Process-stage sort strategy (SORT_MODES).
    sort_mode: str = "hash"
    # Log a warning when tokens beyond emits_per_line were dropped.
    warn_on_overflow: bool = True
    # Map through the hand-written tokenizer kernel (ops/kernels).
    use_pallas: bool = False
    map_impl: str = "auto"
    donate_fold: bool = True
    async_checkpoint: bool = True
    stream_staging_ring: bool = True
    trace: bool = False

    def __post_init__(self):
        if self.key_width <= 0 or self.key_width % 4 != 0:
            raise ValueError("key_width must be a positive multiple of 4 (uint32 lanes)")
        if self.line_width <= 0 or self.emits_per_line <= 0 or self.block_lines <= 0:
            raise ValueError("line_width, emits_per_line, block_lines must be positive")
        if self.table_size is not None and self.table_size <= 0:
            raise ValueError("table_size must be positive")
        if self.sort_mode not in SORT_MODES:
            raise ValueError(
                f"sort_mode must be one of {SORT_MODES}, got {self.sort_mode!r}"
            )
        if self.map_impl not in ("auto", "einsum", "gather"):
            raise ValueError(
                "map_impl must be 'auto', 'einsum', or 'gather', "
                f"got {self.map_impl!r}"
            )

    @property
    def key_lanes(self) -> int:
        """Number of 32-bit big-endian lanes a packed key occupies."""
        return self.key_width // 4

    def fingerprint(self) -> str:
        """Stable digest of every config field (sha1 of ``repr``),
        memoized on the frozen instance."""
        fp = self.__dict__.get("_fingerprint")
        if fp is None:
            import hashlib

            fp = hashlib.sha1(repr(self).encode()).hexdigest()[:12]
            object.__setattr__(self, "_fingerprint", fp)
        return fp

    @property
    def emits_per_block(self) -> int:
        """Emit-table rows per block (analog of MAX_EMITS, main.cu:20)."""
        return self.block_lines * self.emits_per_line

    @property
    def resolved_table_size(self) -> int:
        """Accumulator capacity with the None default resolved:
        ``min(65536, max(emits_per_block, 4096))``."""
        if self.table_size is not None:
            return self.table_size
        return min(1 << 16, max(self.emits_per_block, 4096))


DEFAULT_CONFIG = EngineConfig()
