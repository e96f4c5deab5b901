"""PyTorch port, core: config, bytes_ops, packing, KVBatch, bitonic launch
plan, the no-jax import pin and the device rule, each held against the
JAX package on the same seeded inputs.  Every comparison is exact."""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from locust_tpu import config as jconfig
from locust_tpu.core import bytes_ops as jbytes
from locust_tpu.core import packing as jpacking
from locust_tpu.core.kv import KVBatch as JKVBatch
from locust_tpu_torch import config as tconfig
from locust_tpu_torch.core import bytes_ops as tbytes
from locust_tpu_torch.core import packing as tpacking
from locust_tpu_torch.core.kv import KVBatch as TKVBatch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPECIAL_LANES = np.array([0, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF, 1, 0xFF], np.uint32)


def _random_lanes(seed, n, lanes):
    rng = np.random.default_rng(seed)
    out = rng.integers(0, 2**32, (n, lanes), dtype=np.uint32)
    out[: len(SPECIAL_LANES), 0] = SPECIAL_LANES
    out[: len(SPECIAL_LANES), -1] = SPECIAL_LANES[::-1]
    out[len(SPECIAL_LANES)] = 0xFFFFFFFF
    out[len(SPECIAL_LANES) + 1] = 0
    return out


def _t32(a: np.ndarray) -> torch.Tensor:
    """uint32 numpy -> the port's int32 bit-pattern tensor."""
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32).copy())


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


# ------------------------------------------------------------------ config


@pytest.mark.parametrize("kwargs", [
    {},
    {"block_lines": 64, "emits_per_line": 8, "key_width": 16,
     "use_pallas": True, "sort_mode": "bitonic", "table_size": 2048},
    {"line_width": 256, "sort_mode": "hashp1", "warn_on_overflow": False},
])
def test_engine_config_repr_and_fingerprint_equal_jax(kwargs):
    t, j = tconfig.EngineConfig(**kwargs), jconfig.EngineConfig(**kwargs)
    assert repr(t) == repr(j)
    assert t.fingerprint() == j.fingerprint()
    assert t.resolved_table_size == j.resolved_table_size
    assert t.key_lanes == j.key_lanes and t.emits_per_block == j.emits_per_block


def test_config_constants_equal_jax():
    assert tconfig.DELIMITERS == jconfig.DELIMITERS
    assert tconfig.TOKEN_BOUNDARY_EXTRA == jconfig.TOKEN_BOUNDARY_EXTRA
    assert tconfig.FULL_DELIMITERS == jconfig.FULL_DELIMITERS
    assert tconfig.SORT_MODES == jconfig.SORT_MODES
    assert tconfig.HASHT_FAMILY == jconfig.HASHT_FAMILY
    # The knobs that decide results shared with the JAX package.
    for name in ("HASHT_PROBES", "FUSED_TILE_LINES", "FUSED_TABLE_SLOTS",
                 "FUSED_RESIDUAL_ROWS"):
        assert getattr(tconfig, name) == getattr(jconfig, name), name
    with pytest.raises(ValueError):
        tconfig.EngineConfig(key_width=6)
    with pytest.raises(ValueError):
        tconfig.EngineConfig(sort_mode="nope")


@pytest.mark.parametrize("max_fused", [0, 1, 3, 7, 32])
def test_bitonic_schedule_equals_jax(max_fused):
    for kbits in range(1, 22):
        for m in range(1, 17):
            assert tconfig.bitonic_schedule(kbits, m, max_fused) == \
                jconfig.bitonic_schedule(kbits, m, max_fused), (kbits, m)


# ----------------------------------------------------------------- packing


@pytest.mark.parametrize("lanes", [1, 4, 8])
def test_hash_pair_bit_identical(lanes):
    a = _random_lanes(lanes, 4096, lanes)
    jh1, jh2 = jpacking.hash_pair(jnp.asarray(a))
    th1, th2 = tpacking.hash_pair(_t32(a))
    assert np.array_equal(_u32(th1), np.asarray(jh1))
    assert np.array_equal(_u32(th2), np.asarray(jh2))
    assert np.array_equal(tpacking.primary_hash(_t32(a)).numpy(), np.asarray(jh1).astype(np.int64))


def test_fmix32_and_salted_fold_bit_identical():
    a = _random_lanes(7, 2048, 8)
    j = jpacking._fmix32(jnp.asarray(a))
    t = tpacking._fmix32(tpacking.to_u32(_t32(a)))
    assert np.array_equal(t.numpy(), np.asarray(j).astype(np.int64))
    j = jpacking._salted_fold(jnp.asarray(a), 0xC2B2AE3D, 0x01000193)
    t = tpacking._salted_fold(tpacking.to_u32(_t32(a)), 0xC2B2AE3D, 0x01000193)
    assert np.array_equal(t.numpy(), np.asarray(j).astype(np.int64))


@pytest.mark.parametrize("key_width", [4, 16, 32])
def test_pack_unpack_bit_identical(key_width):
    rng = np.random.default_rng(key_width)
    keys = rng.integers(0, 256, (1000, key_width), dtype=np.uint8)
    keys[0] = 0xFF
    keys[1] = 0
    keys[2, ::4] = 0x80
    jl = np.asarray(jpacking.pack_keys(jnp.asarray(keys)))
    tl = tpacking.pack_keys(torch.from_numpy(keys))
    assert tl.dtype == torch.int32
    assert np.array_equal(_u32(tl), jl)
    assert np.array_equal(tpacking.unpack_keys(tl).numpy(), keys)
    assert np.array_equal(
        tpacking.unpack_keys(_t32(jl)).numpy(),
        np.asarray(jpacking.unpack_keys(jnp.asarray(jl))),
    )


# --------------------------------------------------------------- bytes_ops


def _fuzz_rows(seed, n=256, width=128):
    rng = np.random.default_rng(seed)
    alphabet = np.frombuffer(b"ab, .-;\t'\n\r\x00xyz()\"Q\xff", np.uint8)
    return alphabet[rng.integers(0, len(alphabet), (n, width))]


def test_token_masks_equal_jax():
    rows = _fuzz_rows(3)
    jm = jbytes.delimiter_mask(jnp.asarray(rows))
    tm = tbytes.delimiter_mask(torch.from_numpy(rows))
    assert np.array_equal(tm.numpy(), np.asarray(jm))
    in_tok = ~tm
    j_in = ~jm
    assert np.array_equal(tbytes.token_starts(in_tok).numpy(), np.asarray(jbytes.token_starts(j_in)))
    assert np.array_equal(tbytes.token_ends(in_tok).numpy(), np.asarray(jbytes.token_ends(j_in)))
    tid = tbytes.token_ids(tbytes.token_starts(in_tok))
    assert tid.dtype == torch.int32
    assert np.array_equal(tid.numpy(), np.asarray(jbytes.token_ids(jbytes.token_starts(j_in))))


def test_strings_rows_roundtrip_equal_jax():
    strings = [b"", b"abc", b"x" * 200, b"a\x00b", b"tail "]
    t = tbytes.strings_to_rows(strings, 64)
    assert np.array_equal(t, jbytes.strings_to_rows(strings, 64))
    assert tbytes.rows_to_strings(t) == jbytes.rows_to_strings(t)


# ------------------------------------------------------------------ KVBatch


def test_kvbatch_host_pairs_equal_jax():
    rng = np.random.default_rng(11)
    keys = rng.integers(97, 123, (300, 16), dtype=np.uint8)
    keys[:, 5:] *= (rng.random((300, 11)) < 0.3).astype(np.uint8)
    keys[:, 9:] = 0
    values = rng.integers(-5, 100, 300, dtype=np.int32)
    valid = rng.random(300) < 0.7
    j = JKVBatch.from_bytes(jnp.asarray(keys), jnp.asarray(values), jnp.asarray(valid))
    t = TKVBatch.from_bytes(torch.from_numpy(keys), torch.from_numpy(values), torch.from_numpy(valid))
    assert t.to_host_pairs() == j.to_host_pairs()
    assert np.array_equal(_u32(t.key_lanes), np.asarray(j.key_lanes))
    assert int(t.num_valid()) == int(j.num_valid())
    both = TKVBatch.concat(t, TKVBatch.empty(5, 4, "cpu"))
    assert both.size == 305 and both.to_host_pairs() == t.to_host_pairs()


# ------------------------------------------------ import pin, device rule


def test_port_imports_neither_jax_nor_locust_tpu():
    code = (
        "import importlib, pkgutil, sys\n"
        "import locust_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(locust_tpu_torch.__path__, 'locust_tpu_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'locust_tpu.')) or m == 'locust_tpu')\n"
        "assert not bad, bad\n"
        "assert len(names) >= 30, names\n"
        "for sub in ('obs', 'obs.trace', 'obs.schema', 'plan', 'plan.compile', 'plan.optimize',\n"
        "            'apps', 'apps.tfidf', 'apps.inverted_index', 'apps.pagerank', 'cli_apps',\n"
        "            'io.native_ingest', 'io.corpus', 'utils.roofline', 'utils.profiling',\n"
        "            'utils.checks', 'utils.faultplan', 'obs.attribution'):\n"
        "    assert 'locust_tpu_torch.' + sub in names, sub\n"
        "print('ok', len(names))\n"
    )
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    out = subprocess.run(
        [sys.executable, "-c", code], env=env, cwd=REPO,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_engine_and_cli_raise_without_cuda(monkeypatch, tmp_path):
    from locust_tpu_torch import cli
    from locust_tpu_torch.engine import MapReduceEngine

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tconfig.EngineConfig(sort_mode="bitonic", use_pallas=True)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        MapReduceEngine(cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        MapReduceEngine(cfg, device="cuda")
    assert MapReduceEngine(cfg, device="cpu").device.type == "cpu"
    f = tmp_path / "in.txt"
    f.write_bytes(b"a b\n")
    assert cli.main([str(f)]) == 1
    assert cli.main([str(f), "--backend", "cpu"]) == 0


def test_unported_sort_modes_raise_not_implemented(tmp_path):
    """Every sort mode is ported (slice 5); what is left of this surface,
    the breaker failover of run_checkpointed, raises NotImplementedError
    naming its ROADMAP item, and an unknown mode is refused."""
    from locust_tpu_torch.engine import MapReduceEngine
    from locust_tpu_torch.ops.process_stage import sort_and_compact

    for mode in tconfig.SORT_MODES:
        assert MapReduceEngine(tconfig.EngineConfig(sort_mode=mode), device="cpu")
    eng = MapReduceEngine(tconfig.EngineConfig(sort_mode="hash"), device="cpu")
    with pytest.raises(NotImplementedError, match="queue 1 item 8"):
        eng.run_checkpointed(np.zeros((4, 128), np.uint8), str(tmp_path), breaker=object())
    with pytest.raises(ValueError, match="unknown sort mode"):
        sort_and_compact(eng.empty_table(), "quick")
    with pytest.raises(ValueError, match="sort_mode must be one of"):
        tconfig.EngineConfig(sort_mode="quick")


def test_kernel_wrappers_refuse_devices_without_a_kernel():
    from locust_tpu_torch.ops.kernels.sort import bitonic_sort_rows
    from locust_tpu_torch.ops.kernels.tokenize import tokenize_block_kernel

    with pytest.raises(ValueError, match="no kernel"):
        tokenize_block_kernel(torch.zeros((4, 128), dtype=torch.uint8, device="meta"), 8, 16)
    with pytest.raises(ValueError, match="no kernel"):
        bitonic_sort_rows(torch.zeros(4, dtype=torch.int32, device="meta"),
                          torch.zeros((4, 2), dtype=torch.int32, device="meta"))
