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
import functools
import os

# Tokenization delimiter set, byte for byte the reference's strtok
# delimiters (reference MapReduce/src/main.cu:138).
DELIMITERS: bytes = b" ,.-;:'()\"\t"

# Process-stage sort strategies, named as in the JAX package
# (ops/process_stage.py).
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

# Blocks that run_stream stages into one segment and folds with ONE
# fused-kernel launch (engine._run_stream_fused, the JAX package's
# fold_segment); clamped by fused_stream_seg_blocks.
FUSED_STREAM_BLOCKS: int = int(os.environ.get("LOCUST_FUSED_STREAM_BLOCKS", 8))
if FUSED_STREAM_BLOCKS < 1:
    raise ValueError(
        f"LOCUST_FUSED_STREAM_BLOCKS must be >= 1, got {FUSED_STREAM_BLOCKS}"
    )

# The JAX package's cap on the lines of one interpret-mode kernel call
# off the TPU.  The port's CPU path (the kernel's plain version) keeps it
# in fused_stream_seg_blocks, so that both packages cut a stream into the
# same segments on the CPU.
FUSED_INTERPRET_MAX_LINES: int = int(
    os.environ.get("LOCUST_FUSED_INTERPRET_MAX_LINES", 8192)
)
if FUSED_INTERPRET_MAX_LINES < 0:
    raise ValueError(
        f"LOCUST_FUSED_INTERPRET_MAX_LINES must be >= 0, "
        f"got {FUSED_INTERPRET_MAX_LINES}"
    )


def fused_stream_seg_blocks(emits_per_block: int, block_lines: int, on_device: bool) -> int:
    """Blocks per streaming segment of the fused kernel.  A segment's
    emits stay below 2^24 (the JAX kernel's f32 count bound, kept for
    parity); off the device (the plain version on the CPU) a segment also
    keeps to FUSED_INTERPRET_MAX_LINES lines, as JAX does off the TPU."""
    cap = max(1, ((1 << 24) - 1) // max(1, emits_per_block))
    seg = min(FUSED_STREAM_BLOCKS, cap)
    if not on_device and block_lines > 0:
        seg = min(seg, max(1, FUSED_INTERPRET_MAX_LINES // block_lines))
    return max(1, seg)


# Bytes that end a token on the device beyond the strtok set: NUL (row
# padding and embedded NULs) and the newline pair.
TOKEN_BOUNDARY_EXTRA: bytes = b"\x00\n\r"
FULL_DELIMITERS: bytes = DELIMITERS + TOKEN_BOUNDARY_EXTRA

# Bitonic sort tile of the CUDA kernel (ops/kernels/sort.py): 2^11
# elements of one 64-bit (key, row index) word = 16 KB of shared memory
# and 512 threads per block, so a sort of 2^18 elements keeps 128 blocks
# in flight on the H100's 132 SMs (2^12 tiles would leave half of them
# idle).  Every substage whose compare distance is below the tile runs
# inside one block.
BITONIC_TILE_BITS: int = 11
# Largest block of the kernel: 2^12 words (32 KB of shared memory, 1,024
# threads of 4 words each).
BITONIC_MAX_BLOCK_BITS: int = 12
# Most cross-tile substages one launch runs; the block keeps at least
# 2^3 consecutive words (64 B) beside them.
BITONIC_MAX_CROSS_BITS: int = 9


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


@functools.lru_cache(maxsize=None)
def bitonic_launch_plan(kbits: int, m: int):
    """Launch plan of the CUDA bitonic kernel for ``n = 2^kbits`` elements
    and a tile of ``2^m``: a tuple of launches ``(block_bits, low_bits,
    cross_at, stages)``, in execution order.

    A launch's block holds ``2^block_bits`` elements: its local index
    bits below ``low_bits`` are the global index bits ``0..low_bits-1``,
    the others are the global bits from ``cross_at`` up; the block index
    fills the remaining global bits.  ``stages`` are ``(s, t_hi, t_lo)``
    triples run back to back; substage ``t`` compares global bit ``t-1``,
    which lies among the block's bits.  A tile launch has
    ``block_bits == low_bits == cross_at == m``; a cross launch runs up
    to ``BITONIC_MAX_CROSS_BITS`` substages of distance ``>= 2^m`` on
    blocks of coalesced runs of ``2^low_bits`` elements.  With
    ``kbits - m <= BITONIC_MAX_CROSS_BITS`` that is ``1 + 2*(kbits - m)``
    launches: the first tile launch, then per stage above the tile one
    cross and one tile launch.  The kernel takes blocks of 2^8 to
    ``2^BITONIC_MAX_BLOCK_BITS`` words."""
    if not 8 <= m <= min(kbits, BITONIC_MAX_BLOCK_BITS):
        raise ValueError(f"tile bits {m} outside 8..min({kbits}, {BITONIC_MAX_BLOCK_BITS})")
    plan = [(m, m, m, tuple((s, s, 1) for s in range(1, m + 1)))]
    for s in range(m + 1, kbits + 1):
        hi = s - 1  # global bits s-1 .. m, top down
        while hi >= m:
            c = min(BITONIC_MAX_CROSS_BITS, hi - m + 1)
            block = min(BITONIC_MAX_BLOCK_BITS, max(m, c + 4))
            plan.append((block, block - c, hi - c + 1, ((s, hi + 1, hi - c + 2),)))
            hi -= c
        plan.append((m, m, m, ((s, m, 1),)))
    return tuple(plan)


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Static shape/capacity configuration of one MapReduce pipeline.

    Same fields, order and defaults as the JAX package's ``EngineConfig``;
    the fields that only the JAX executor reads (``map_impl``,
    ``donate_fold``) are kept so that ``repr`` and ``fingerprint``
    agree, and a checkpoint names the same run in both.
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
    # Snapshots on the background writer (io/snapshot.py), not in the loop.
    async_checkpoint: bool = True
    # run_stream stages blocks through reusable (page-locked) buffers.
    stream_staging_ring: bool = True
    # The engine enables telemetry (obs) when it is built.
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
