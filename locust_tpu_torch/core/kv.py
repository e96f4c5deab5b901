"""KV data model: fixed-width key/value batches as a dataclass of tensors.

Port of ``locust_tpu/core/kv.py``.  Keys are packed big-endian 32-bit
lanes held as int32 bit patterns (core/packing.py), values are int32 and
validity is an explicit bool mask.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from locust_tpu_torch.core import bytes_ops, packing


@dataclasses.dataclass
class KVBatch:
    """A batch of (key, value) emits.

    Attributes:
      key_lanes: int32 ``[N, L]`` holding the uint32 big-endian lanes.
      values: int32 ``[N]``.
      valid: bool ``[N]``.
    """

    key_lanes: torch.Tensor
    values: torch.Tensor
    valid: torch.Tensor

    @property
    def size(self) -> int:
        return self.key_lanes.shape[0]

    def num_valid(self) -> torch.Tensor:
        return self.valid.sum(dtype=torch.int32)

    def tensors(self) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        return self.key_lanes, self.values, self.valid

    def clone(self) -> "KVBatch":
        return KVBatch(*(t.clone() for t in self.tensors()))

    @classmethod
    def from_bytes(cls, keys: torch.Tensor, values: torch.Tensor, valid: torch.Tensor) -> "KVBatch":
        return cls(
            key_lanes=packing.pack_keys(keys),
            values=values.to(torch.int32),
            valid=valid.to(torch.bool),
        )

    @classmethod
    def concat(cls, *batches: "KVBatch") -> "KVBatch":
        return cls(
            key_lanes=torch.cat([b.key_lanes for b in batches]),
            values=torch.cat([b.values for b in batches]),
            valid=torch.cat([b.valid for b in batches]),
        )

    @classmethod
    def empty(cls, n: int, key_lanes: int, device) -> "KVBatch":
        return cls(
            key_lanes=torch.zeros((n, key_lanes), dtype=torch.int32, device=device),
            values=torch.zeros((n,), dtype=torch.int32, device=device),
            valid=torch.zeros((n,), dtype=torch.bool, device=device),
        )

    def to_host_pairs(self) -> list[tuple[bytes, int]]:
        """Host-side: decode live entries to (key bytes, value) pairs."""
        valid = self.valid.cpu().numpy()
        live_lanes = self.key_lanes.cpu().numpy()[valid].view(np.uint32)
        live_values = self.values.cpu().numpy()[valid]
        n_live, n_lanes = live_lanes.shape
        keys = live_lanes.astype(">u4").view(np.uint8).reshape(n_live, n_lanes * 4)
        return [
            (k, int(v))
            for k, v in zip(bytes_ops.rows_to_strings(keys), live_values)
        ]
