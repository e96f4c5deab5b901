"""PyTorch port, the seeded Zipf corpus (``io/corpus.py``) and the
roofline model (``utils/roofline.py``): the corpus is byte for byte the
JAX generator's; the JAX traffic model gives the JAX package's numbers
for every sort mode; the least-bytes counts equal hand-worked numbers at
``[4096, 128]``; and ``summarize`` never reads above 100% of the peak."""

import torch_threads  # noqa: F401 - first: one torch thread per test process

import pytest

from locust_tpu.io import corpus as jcorpus
from locust_tpu.utils import roofline as jroof
from locust_tpu_torch.config import SORT_MODES, EngineConfig
from locust_tpu_torch.io import corpus as tcorpus
from locust_tpu_torch.utils import roofline as troof

H100 = "NVIDIA H100 80GB HBM3"


@pytest.mark.parametrize("seed,n_vocab,zipf,wpl", [
    (0, 30_000, 1.1, 10), (1, 30_000, 1.1, 10), (7, 500, 1.3, 7), (3, 100_000, 1.05, 12),
])
def test_synthetic_corpus_equals_jax(seed, n_vocab, zipf, wpl):
    kw = dict(n_vocab=n_vocab, seed=seed, zipf=zipf, words_per_line=wpl)
    got = tcorpus.synthetic_corpus(60_000, **kw)
    assert got == jcorpus.synthetic_corpus(60_000, **kw)
    assert sum(len(ln) + 1 for ln in got) >= 60_000


@pytest.mark.parametrize("target,chunk", [(150_000, 16_000_000), (150_000, 40_000),
                                          (99_999, 7_777), (1, 1)])
@pytest.mark.parametrize("seed", [0, 5])
def test_write_corpus_equals_jax(tmp_path, target, chunk, seed):
    t, j = tmp_path / "t.txt", tmp_path / "j.txt"
    nt = tcorpus.write_corpus(str(t), target, chunk_bytes=chunk, seed=seed, n_vocab=2_000)
    nj = jcorpus.write_corpus(str(j), target, chunk_bytes=chunk, seed=seed, n_vocab=2_000)
    assert nt == nj == t.stat().st_size
    assert t.read_bytes() == j.read_bytes()


def test_write_corpus_rejects_bad_chunk(tmp_path):
    with pytest.raises(ValueError):
        tcorpus.write_corpus(str(tmp_path / "x"), 10, chunk_bytes=0)


def _configs():
    cli = EngineConfig()
    small = EngineConfig(block_lines=64, line_width=128, key_width=16, emits_per_line=8)
    return [(cli, 103), (small, 5)]


@pytest.mark.parametrize("mode", SORT_MODES)
@pytest.mark.parametrize("which", [0, 1])
def test_traffic_model_equals_jax(mode, which):
    cfg, n_blocks = _configs()[which]
    args = (mode, cfg.key_lanes, cfg.emits_per_block, cfg.resolved_table_size, n_blocks)
    kw = dict(block_lines=cfg.block_lines, line_width=cfg.line_width)
    variants = ("batch", "stream", "mesh") if mode == "fused" else ("batch",)
    for fv in variants:
        assert troof.pipeline_sort_traffic(*args, fused_variant=fv, **kw) == \
            jroof.pipeline_sort_traffic(*args, fused_variant=fv, **kw)
    if mode == "fused":
        for seg in (1, 3, 8):
            assert troof.pipeline_sort_traffic(*args, fused_variant="stream",
                                               stream_seg_blocks=seg, **kw) == \
                jroof.pipeline_sort_traffic(*args, fused_variant="stream",
                                            stream_seg_blocks=seg, **kw)
    else:
        assert troof.pipeline_sort_traffic(*args) == jroof.pipeline_sort_traffic(*args)
    for n in (0, 1, 2, 1000, 147_456, cfg.resolved_table_size + cfg.emits_per_block, 1 << 20):
        assert troof.sort_pass_count(n, mode) == jroof.sort_pass_count(n, mode)
    for lanes in (1, 4, 8, 16):
        assert troof.mode_row_bytes(mode, lanes) == jroof.mode_row_bytes(mode, lanes)


def test_traffic_model_at_cli_defaults_reads_the_tpu_schedule():
    """The JAX model at the CLI defaults over 103 blocks: 171 passes
    (lax.sort's k(k+1)/2) for lex, 13 for the Pallas bitonic schedule."""
    cfg = EngineConfig()
    args = (cfg.key_lanes, cfg.emits_per_block, cfg.resolved_table_size, 103)
    lex = troof.pipeline_sort_traffic("lex", *args)
    bit = troof.pipeline_sort_traffic("bitonic", *args)
    assert (lex["sort_passes"], bit["sort_passes"]) == (171, 13)
    assert lex["est_sort_traffic_bytes"] == 207_771_402_240
    assert bit["est_sort_traffic_bytes"] == 15_795_486_720
    fused = troof.pipeline_sort_traffic("fused", *args, block_lines=4096, line_width=128)
    assert fused["est_sort_traffic_bytes"] == jroof.pipeline_sort_traffic(
        "fused", *args, block_lines=4096, line_width=128)["est_sort_traffic_bytes"]


@pytest.mark.parametrize("mode", SORT_MODES)
def test_summarize_keeps_the_jax_fields(mode):
    cfg = EngineConfig()
    args = (mode, cfg.key_lanes, cfg.emits_per_block, cfg.resolved_table_size, 103, 0.25)
    kw = dict(block_lines=4096, line_width=128)
    t = troof.summarize(*args, H100, **kw)
    j = jroof.summarize(*args, "TPU v5e", **kw)
    for k in j:
        if k not in ("device_kind", "hbm_peak_gb_s", "hbm_utilization_pct", "model"):
            assert t[k] == j[k], k
    assert t["hbm_peak_gb_s"] == 3350.0 and t["device_kind"] == H100
    # Utilisation from the folds' least bytes, never the TPU model.
    assert t["min_bytes"] == troof.fold_min_bytes(8, 65536, 103, 4096, 128, t.get("n_segments"))
    assert 0 < t["hbm_utilization_pct"] <= 100
    assert t["hbm_utilization_pct"] == round(100 * round(t["min_bytes"] / 1e9 / 0.25, 2) / 3350, 2)
    assert "TPU" in t["est_sort_traffic_model"]


def test_summarize_refuses_a_reading_above_the_peak():
    """lex's TPU-model traffic at 1.2 s would 'read' 173 GB/s, fine; its
    least bytes in a microsecond would read far past 3.35 TB/s: raised."""
    args = ("lex", 8, 81920, 65536, 103)
    assert troof.summarize(*args, 0.2, H100, 4096, 128)["hbm_utilization_pct"] <= 100
    with pytest.raises(ValueError, match="impossible"):
        troof.summarize(*args, 1e-6, H100, 4096, 128)
    # An unknown device (the CPU) claims no utilisation at all.
    cpu = troof.summarize(*args, 1e-6, "cpu", 4096, 128)
    assert cpu["hbm_peak_gb_s"] is None and cpu["hbm_utilization_pct"] is None


def test_min_bytes_hand_worked_at_cli_block():
    """[4096, 128], E=20, K=32 (the CLI defaults), worked by hand."""
    # A: 524,288 bytes in; 2,621,440 key + 81,920 valid bytes + 4 out.
    assert troof.tokenize_min_bytes(4096, 128, 20, 32) == 3_227_652
    assert troof.tokenize_min_ops(4096, 128) == 524_288
    # B at the fold's n = 65,536 + 81,920 = 147,456 rows x (8 lanes + value):
    # 147,456 * 4 * 10 bytes in and out.
    assert troof.bitonic_min_bytes(147_456, 9) == 11_796_480
    # 2^18 padded: 131,072 compare-exchanges a substage, 18*19/2 substages.
    assert troof.bitonic_min_ops(147_456) == 131_072 * 171
    assert troof.bitonic_min_ops(1) == 512 * 55  # the kernel's 1,024 floor
    # C per block: 524,288 in; (8,192 table + 128 tiles * 32) rows of
    # 37 bytes, overflow and flag out.
    assert troof.fused_min_bytes(4096, 128, 32) == 524_288 + 12_288 * 37 + 5 == 978_949
    # C per run_stream segment of 8 blocks: 1,024 tiles.
    assert troof.fused_min_bytes(32_768, 128, 32) == 4_194_304 + 40_960 * 37 + 5 == 5_709_829
    # A fold of 103 blocks at table 65,536: rows in, the table in and out
    # per fold (37 + 4 + 1 = 37 bytes a row at 8 lanes).
    assert troof.table_row_bytes(8) == 37
    assert troof.fold_min_bytes(8, 65536, 103, 4096, 128) == \
        103 * 524_288 + 2 * 103 * 65536 * 37
    assert troof.fold_min_bytes(8, 65536, 103, 4096, 128, n_folds=13) == \
        103 * 524_288 + 2 * 13 * 65536 * 37


def test_peak_table_is_the_data_sheet():
    assert troof.PEAK_HBM_GB_S == {H100: 3350.0}
