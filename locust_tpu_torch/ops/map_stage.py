"""Map stage: data-parallel tokenization into fixed-slot KV emits.

Port of ``locust_tpu/ops/map_stage.py``.  Each line owns
``emits_per_line`` slots; tokens past the cap are dropped and counted
(the reference warns and drops, main.cu:141-144).  ``cfg.use_pallas``
selects the hand-written tokenizer kernel (ops/kernels/tokenize.py);
otherwise the plain tensor formulation runs on the block's device.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from locust_tpu_torch.config import EngineConfig
from locust_tpu_torch.core.kv import KVBatch
from locust_tpu_torch.ops.kernels.tokenize import (
    tokenize_block_kernel,
    tokenize_reference,
)


class TokenizeResult(NamedTuple):
    keys: torch.Tensor      # uint8 [lines, emits_per_line, key_width]
    valid: torch.Tensor     # bool  [lines, emits_per_line]
    overflow: torch.Tensor  # int32 [] — tokens dropped beyond the per-line cap


def tokenize_block(lines: torch.Tensor, cfg: EngineConfig) -> TokenizeResult:
    """Tokenize a ``[block_lines, line_width]`` uint8 block with plain
    tensor ops (the JAX "gather" formulation; "einsum" is the TPU's matrix
    unit spelling of the same function)."""
    return TokenizeResult(*tokenize_reference(lines, cfg.emits_per_line, cfg.key_width))


def wordcount_map(lines: torch.Tensor, cfg: EngineConfig) -> tuple[KVBatch, torch.Tensor]:
    """The WordCount map_fn: emit ``(token, 1)`` per token.  Returns the
    flat emit batch ``[block_lines * emits_per_line]`` and the overflow
    counter."""
    if cfg.use_pallas:
        keys, valid, overflow = tokenize_block_kernel(
            lines, cfg.emits_per_line, cfg.key_width
        )
    else:
        keys, valid, overflow = tokenize_block(lines, cfg)
    flat_keys = keys.reshape(-1, cfg.key_width)
    flat_valid = valid.reshape(-1)
    values = torch.ones(flat_keys.shape[0], dtype=torch.int32, device=lines.device)
    return KVBatch.from_bytes(flat_keys, values, flat_valid), overflow
