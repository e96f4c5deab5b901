"""Loopback data-plane microbench: JSON/base64 against binary framing.

Port of ``locust_tpu/distributor/microbench.py``, with the same result
schema.  Times the distributor's fetch path variants against ONE
in-process worker over 127.0.0.1:

  * ``json_w1``   the pre-binary path: one connection and one base64
                  JSON chunk per request (the baseline),
  * ``bin_w1``    binary frames, raw payload, one chunk in flight,
  * ``bin_wK``    binary frames, raw payload, K chunks pipelined,
  * ``bin_wK_z``  binary frames, zlib payload, K chunks pipelined (the
                  default data plane).

The staged file is shaped like a real post-combine intermediate, packed
binary KV of sorted word keys with Zipf-ish counts written by the port's
``io/serde.py``, so the compression ratio means something.  Host and
socket work only: no device is touched.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import tempfile

from locust_tpu_torch.distributor import master
from locust_tpu_torch.distributor.worker import Worker
from locust_tpu_torch.io import serde

VARIANTS = ("json_w1", "bin_w1", "bin_wK", "bin_wK_z")

# Per-variant fetch_file keyword overlays (window filled in at run time).
_VARIANT_KW = {
    "json_w1": dict(use_binary=False, use_zlib=False),
    "bin_w1": dict(use_binary=True, use_zlib=False),
    "bin_wK": dict(use_binary=True, use_zlib=False),
    "bin_wK_z": dict(use_binary=True, use_zlib=True),
}


def synth_intermediate(path: str, target_bytes: int) -> int:
    """Write a post-combine-shaped packed-KV file of ~``target_bytes``:
    sorted distinct word keys, Zipf-flavored int32 counts."""
    pairs = []
    approx = 0
    i = 0
    while approx < target_bytes:
        key = b"token%08d" % i
        pairs.append((key, 1 + (1_000_000 // (i + 1)) % 100_000))
        approx += len(key) + 6  # lens + value columns amortized
        i += 1
    serde.write_kvbin(pairs, path)
    return os.path.getsize(path)


def run_microbench(
    target_bytes: int = 4 << 20,
    # 64KiB chunks: small enough that the JSON path's per-request costs
    # (fresh TCP connection + HMAC + base64 round trip) are visible, the
    # regime the pipelined path exists for.
    chunk_bytes: int = 64 * 1024,
    window: int = 4,
    repeats: int = 3,
    secret: bytes = b"dataplane-microbench",
) -> dict:
    """Measure every variant; returns the schema-pinned result dict.

    Throughput is the best of ``repeats`` (steady-state; the first run
    warms the page cache), wire bytes are exact and repeat-invariant.
    """
    tmp = tempfile.mkdtemp(prefix="locust_dataplane_")
    try:
        remote = os.path.join(tmp, "inter.kvb")
        size = synth_intermediate(remote, target_bytes)
        with open(remote, "rb") as f:
            expect_sha = hashlib.sha256(f.read()).hexdigest()
        w = Worker(secret=secret, workdir=tmp)
        w.serve_in_thread()
        try:
            variants: dict[str, dict] = {}
            for name in VARIANTS:
                kw = dict(_VARIANT_KW[name])
                kw["window"] = window if name.endswith(("wK", "wK_z")) else 1
                best = None
                for r in range(max(1, repeats)):
                    local = os.path.join(tmp, f"got_{name}_{r}")
                    st = master.fetch_file(
                        w.addr, remote, local, secret,
                        expect_sha=expect_sha,
                        chunk_bytes=chunk_bytes,
                        **kw,
                    )
                    os.unlink(local)
                    if best is None or (st["mb_s"] or 0) > (best["mb_s"] or 0):
                        best = st
                best.pop("node", None)
                variants[name] = best
        finally:
            w._shutdown.set()

        def mbs(name: str) -> float:
            return float(variants[name]["mb_s"] or 0.0)

        json_wire = variants["json_w1"]["wire_bytes"]
        z_wire = variants["bin_wK_z"]["wire_bytes"]
        return {
            "corpus_bytes": size,
            "chunk_bytes": chunk_bytes,
            "window": window,
            "repeats": repeats,
            "variants": variants,
            "summary": {
                "fetch_mb_s_json": mbs("json_w1"),
                "fetch_mb_s_bin": max(mbs("bin_wK"), mbs("bin_wK_z")),
                "pipeline_speedup": round(
                    max(mbs("bin_wK"), mbs("bin_wK_z"))
                    / max(mbs("json_w1"), 1e-9),
                    3,
                ),
                "wire_bytes_json": json_wire,
                "wire_bytes_bin_zlib": z_wire,
                "wire_reduction": round(json_wire / max(z_wire, 1), 3),
                "compression_ratio": round(
                    variants["bin_wK_z"]["bytes"] / max(z_wire, 1), 3
                ),
            },
        }
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
