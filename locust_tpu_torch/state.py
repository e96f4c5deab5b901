"""State carried across runs and packages: the accumulator table.

The engine's only state is its bounded table (the analog of a model's
weights).  These helpers move it between the JAX package's numpy form
(uint32 key lanes) and the port's tensors (int32 lanes holding the same
bits), and read and write the checkpoint snapshot of ``run_stream`` and
``run_checkpointed``: one npz in the JAX engine's format field for field
(``locust_tpu/engine.py`` ``_save_state``), so either package resumes
the other's.  With them JAX can fold part of a corpus and the port fold
the rest: ``MapReduceEngine.run(rest, acc=table_from_jax(...))`` gives
the answer of JAX's whole run.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from locust_tpu_torch.core.kv import KVBatch
from locust_tpu_torch.io.snapshot import finalize_snapshot


class Snapshot(NamedTuple):
    acc: KVBatch
    next_block: int
    overflow: int
    max_distinct: int
    fingerprint: str


def table_from_jax(key_lanes: np.ndarray, values: np.ndarray, valid: np.ndarray,
                   device) -> KVBatch:
    """JAX table arrays (uint32 lanes ``[N, L]``, int32 values, bool valid)
    -> a port ``KVBatch`` on ``device``; the lanes keep their bits."""
    lanes = np.ascontiguousarray(key_lanes, dtype=np.uint32).view(np.int32)
    return KVBatch(
        key_lanes=torch.from_numpy(lanes.copy()).to(device),
        values=torch.from_numpy(np.asarray(values, dtype=np.int32).copy()).to(device),
        valid=torch.from_numpy(np.asarray(valid, dtype=bool).copy()).to(device),
    )


def table_to_numpy(table: KVBatch) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Port table -> the JAX package's numpy form (uint32 lanes, int32
    values, bool valid)."""
    return (
        table.key_lanes.cpu().numpy().view(np.uint32),
        table.values.cpu().numpy(),
        table.valid.cpu().numpy(),
    )


def save_snapshot(path: str, acc: KVBatch, next_block: int, overflow: torch.Tensor,
                  max_distinct: torch.Tensor, fingerprint: str) -> None:
    """Write the snapshot as one atomically replaced npz, so that table,
    cursor and counters never tear apart: uint32 key lanes, int32 values,
    bool valid, int64 ``next_block``, int32 ``overflow`` and
    ``max_distinct``, and the run's fingerprint, as the JAX engine writes
    them.  The temporary name keeps the .npz suffix (np.savez appends it
    otherwise).  The copies to the host wait for the device."""
    lanes, values, valid = table_to_numpy(acc)
    tmp = path + ".tmp.npz"
    np.savez_compressed(
        tmp,
        key_lanes=lanes,
        values=values,
        valid=valid,
        next_block=np.int64(next_block),
        overflow=overflow.cpu().numpy().astype(np.int32),
        max_distinct=max_distinct.cpu().numpy().astype(np.int32),
        fingerprint=np.str_(fingerprint),
    )
    finalize_snapshot(tmp, path)


def load_jax_checkpoint(path: str, device) -> Snapshot:
    """Read a ``state.npz`` snapshot, written by either package's
    checkpointing: the table plus the block cursor and counters it was
    taken at."""
    with np.load(path) as z:
        return Snapshot(
            acc=table_from_jax(z["key_lanes"], z["values"], z["valid"], device),
            next_block=int(z["next_block"]),
            overflow=int(z["overflow"]),
            max_distinct=int(z["max_distinct"]),
            fingerprint=str(z["fingerprint"]),
        )
