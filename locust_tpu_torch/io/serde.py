"""Intermediate-result serde: what a staged map node writes and the reduce
node reads.

Port of ``locust_tpu/io/serde.py``; every file it writes is byte for byte
the JAX writer's.  Two intermediate formats:

* ``tsv``: ``key<TAB>value`` lines, the reference's ``/tmp/out.txt``
  (reference MapReduce/src/main.cu:116-124), written without the
  reference's trailing key space and read with or without it.
* ``bin``: the packed binary KV format "LKVB" v1 (the distributor's data
  plane): columnar lens / key blob / values, decoded with
  ``np.frombuffer``.

``read_intermediate`` sniffs the magic per file, so mixed inputs reduce.
``read_tsv`` parses through the native reader (``csrc/ingest.cpp``) for
keys up to 256 bytes, and through the pure-Python parser, its semantic
reference, for wider keys or when the caller passes ``use_native=False``.
``write_npz``/``read_npz`` store a
table as the JAX package does (uint32 key lanes).
"""

from __future__ import annotations

import re
import struct

import numpy as np
import torch

from locust_tpu_torch.core import bytes_ops
from locust_tpu_torch.core.kv import KVBatch
from locust_tpu_torch.io import native_ingest

# Packed binary KV intermediate ("LKVB" v1).  Layout, all little-endian:
#   0   4  magic b"LKVB"
#   4   1  version (1)
#   5   1  flags (0)
#   6   2  reserved (0)
#   8   4  count (u32)
#  12   4  key-blob length (u32)
#  16      u16[count] key lengths
#          key blob (concatenated raw key bytes)
#          i32[count] values
KVB_MAGIC = b"LKVB"
KVB_VERSION = 1
_KVB_HEADER = struct.Struct("<4sBBHII")

INTERMEDIATE_FORMATS = ("tsv", "bin")

# A TSV value: optional ' '/'\t'/'\r' padding, sign, digits; nothing else.
_TSV_VALUE = re.compile(rb"[ \t\r]*([+-]?[0-9]+)[ \t\r]*\Z")


def write_tsv(pairs: list[tuple[bytes, int]], path: str) -> None:
    """Write live (key, value) pairs as ``key\\tvalue`` lines."""
    with open(path, "wb") as f:
        for k, v in pairs:
            f.write(k + b"\t" + str(int(v)).encode() + b"\n")


def write_kvbin(pairs: list[tuple[bytes, int]], path: str) -> None:
    """Write live (key, value) pairs in the packed binary KV format."""
    for k, _ in pairs:
        if len(k) > 0xFFFF:
            raise ValueError(f"key of {len(k)} bytes exceeds the u16 length field")
    lens = np.fromiter((len(k) for k, _ in pairs), np.uint16, len(pairs))
    values = np.fromiter((int(v) for _, v in pairs), np.int64, len(pairs))
    if len(values) and not (values.min() >= -(2**31) and values.max() < 2**31):
        raise OverflowError(f"value outside int32 in {path!r}")
    blob = b"".join(k for k, _ in pairs)
    with open(path, "wb") as f:
        f.write(_KVB_HEADER.pack(KVB_MAGIC, KVB_VERSION, 0, 0, len(pairs), len(blob)))
        f.write(lens.astype("<u2").tobytes())
        f.write(blob)
        f.write(values.astype("<i4").tobytes())


def read_kvbin(path: str, key_width: int) -> tuple[np.ndarray, np.ndarray]:
    """Packed binary KV -> (NUL-padded ``[n, key_width]`` uint8 key rows,
    int32 values), keys cut to ``key_width``.  Any structural
    inconsistency raises ValueError: a damaged file never yields fewer or
    garbled pairs."""
    with open(path, "rb") as f:
        data = f.read()
    if len(data) < _KVB_HEADER.size:
        raise ValueError(f"{path!r}: truncated KVB header")
    magic, version, _flags, _resv, count, blob_len = _KVB_HEADER.unpack(
        data[: _KVB_HEADER.size]
    )
    if magic != KVB_MAGIC:
        raise ValueError(f"{path!r}: bad KVB magic {magic!r}")
    if version != KVB_VERSION:
        raise ValueError(f"{path!r}: unsupported KVB version {version}")
    want = _KVB_HEADER.size + 2 * count + blob_len + 4 * count
    if len(data) != want:
        raise ValueError(
            f"{path!r}: KVB size mismatch (have {len(data)}B, header implies {want}B)"
        )
    off = _KVB_HEADER.size
    lens = np.frombuffer(data, "<u2", count, off).astype(np.int64)
    off += 2 * count
    if int(lens.sum()) != blob_len:
        raise ValueError(f"{path!r}: KVB key lengths do not sum to the blob")
    blob = np.frombuffer(data, np.uint8, blob_len, off)
    off += blob_len
    values = np.frombuffer(data, "<i4", count, off).astype(np.int32)
    rows = np.zeros((count, key_width), np.uint8)
    if count:
        # Byte i of the blob lands at (its key's row, its offset in the
        # key), dropped past key_width.
        starts = np.concatenate(([0], np.cumsum(lens)[:-1]))
        row_of = np.repeat(np.arange(count), lens)
        col_of = np.arange(blob_len) - np.repeat(starts, lens)
        keep = col_of < key_width
        rows[row_of[keep], col_of[keep]] = blob[keep]
    return rows, values


def is_kvbin(path: str) -> bool:
    with open(path, "rb") as f:
        return f.read(len(KVB_MAGIC)) == KVB_MAGIC


def write_intermediate(pairs: list[tuple[bytes, int]], path: str, fmt: str = "tsv") -> None:
    if fmt not in INTERMEDIATE_FORMATS:
        raise ValueError(f"unknown intermediate format {fmt!r}")
    (write_kvbin if fmt == "bin" else write_tsv)(pairs, path)


def read_intermediate(path: str, key_width: int,
                      use_native: bool = True) -> tuple[np.ndarray, np.ndarray]:
    """Format-sniffing read: packed binary KV by magic, else TSV."""
    if is_kvbin(path):
        return read_kvbin(path, key_width)
    return read_tsv(path, key_width, use_native=use_native)


def read_tsv(path: str, key_width: int,
             use_native: bool = True) -> tuple[np.ndarray, np.ndarray]:
    """``key\\tvalue`` TSV -> (padded key rows, int32 values).  Splits on
    the first tab like the reference's parser (main.cu:84-97), strips a
    key's trailing spaces, skips blank and malformed rows, and raises on
    a value outside int32.  The native parser reads keys up to 256 bytes
    wide (its per-line key buffer); wider keys take the Python parser."""
    if use_native and key_width <= 256:
        return native_ingest.read_tsv(path, key_width)
    keys: list[bytes] = []
    values: list[int] = []
    with open(path, "rb") as f:
        for line in f:
            line = line.rstrip(b"\n").rstrip(b"\r")
            if not line:
                continue
            key, _, val = line.partition(b"\t")
            key = key.rstrip(b" ")  # the reference writes "key \t..."
            if not key:
                continue
            m = _TSV_VALUE.fullmatch(val) if len(val) <= 63 else None
            if m is None:
                continue  # malformed row: skipped, like the reference's atoi-0 rows
            v = int(m.group(1))
            if not (-(2**31) <= v < 2**31):
                raise OverflowError(f"TSV value {v} in {path!r} does not fit int32")
            values.append(v)
            keys.append(key)
    return bytes_ops.strings_to_rows(keys, key_width), np.asarray(values, dtype=np.int32)


def fingerprint_corpus(rows: np.ndarray, **extra) -> str:
    """Resume identity of a checkpointed run over ``rows``: the row count,
    a digest of the content and the pipeline identity in ``extra``
    (config repr, combine, map_fn name), as the JAX package builds it."""
    import hashlib
    import json

    return json.dumps(
        {
            "n_rows": int(rows.shape[0]),
            "digest": hashlib.sha256(np.ascontiguousarray(rows).tobytes()).hexdigest(),
            **extra,
        },
        sort_keys=True,
    )


def write_npz(batch: KVBatch, path: str) -> None:
    """A table as a compressed npz in the JAX package's dtypes."""
    np.savez_compressed(
        path,
        key_lanes=batch.key_lanes.cpu().numpy().view(np.uint32),
        values=batch.values.cpu().numpy(),
        valid=batch.valid.cpu().numpy(),
    )


def read_npz(path: str, device="cpu") -> KVBatch:
    with np.load(path) as z:
        return KVBatch(
            key_lanes=torch.from_numpy(z["key_lanes"].view(np.int32).copy()).to(device),
            values=torch.from_numpy(z["values"].astype(np.int32)).to(device),
            valid=torch.from_numpy(z["valid"].astype(bool)).to(device),
        )
