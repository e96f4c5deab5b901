"""PyTorch port, the distributed sample sort (``DistributedSort``,
``SortResult``, ``sort_strings``) as a gloo world of 2 CPU processes
against the JAX package's on ``make_mesh(2)``, on the inputs of
tests/test_apps.py (tests/torch_mesh_rig.py): random strings, values
carried, a duplicate-heavy input that forces a retry, the retry budget's
error, a mostly padded shard, and the overflow at each skew factor the
retries take, equal to JAX's.  The sorted keys must be equal; the values
of a run of equal keys are compared as a multiset, since JAX's sorts are
not stable and the port's are.  And ``core/packing.lanes_geq_table``
against JAX's on random lanes and on keys sharing prefixes."""

import torch_threads  # noqa: F401 - first: one torch thread per test process

import numpy as np
import pytest
import torch

import torch_mesh_rig as rig

from locust_tpu import apps as japps
from locust_tpu.core.packing import lanes_geq_table as jgeq
from locust_tpu.parallel.mesh import make_mesh as jmake_mesh
from locust_tpu_torch.core.packing import lanes_geq_table


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("sort_world"))
    procs = rig.start_world("torch", 2, out, "apps_sort")
    state = {"procs": procs, "out": out, "result": None}
    yield state
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()


def _port(world):
    if world["result"] is None:
        world["result"] = rig.finish_world(world["procs"], world["out"], "torch")
    return world["result"]


@pytest.mark.parametrize("name", sorted(rig.SORT))
def test_world_of_two_equals_jax(world, name):
    want = rig.run_sort(japps, rig.jax_pkg(), jmake_mesh(2), name)
    got = dict(_port(world)[f"sort_{name}"])
    assert got.keys() == want.keys()
    if "pairs" in want:
        assert rig.sorted_runs(got.pop("pairs")) == rig.sorted_runs(want.pop("pairs"))
    assert got == want


def test_scenarios_exercise_what_they_name(world):
    got = _port(world)
    for name in ("random", "dups", "dups_retry"):
        words = rig.sort_words(rig.SORT[name][1])
        assert got[f"sort_{name}"]["keys"] == [w.hex() for w in sorted(words)], name
    # The duplicate-heavy input overflows below a skew factor of 2 on two
    # ranks, so sort_strings from 0.5 retried twice; a budget of none raises.
    assert got["sort_dups_overflow"]["overflow"] == [476, 386, 242, 0, 0]
    assert "dropped" in got["sort_budget"]["error"]
    assert got["sort_padding"]["overflow"] == 0
    words = rig.sort_words("values")
    assert [words[v] for _, v in got["sort_values"]["pairs"]] == sorted(words)


def _lanes(rng, n, lanes, alphabet):
    return rng.choice(alphabet, size=(n, lanes)).astype(np.uint32)


@pytest.mark.parametrize("lanes", [1, 4, 8])
def test_lanes_geq_table_equals_jax(lanes):
    rng = np.random.default_rng(lanes)
    # Few distinct lane values, the high bit among them: many equal
    # prefixes, unsigned order where signed order would differ.
    alphabet = np.array([0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF], np.uint32)
    for keys, spl in ((_lanes(rng, 500, lanes, alphabet), _lanes(rng, 7, lanes, alphabet)),
                      (rng.integers(0, 2**32, (300, lanes), dtype=np.uint32),
                       rng.integers(0, 2**32, (3, lanes), dtype=np.uint32))):
        spl[0] = keys[0]  # an equal key: >=
        want = np.asarray(jgeq(keys, spl))
        got = lanes_geq_table(torch.from_numpy(keys.view(np.int32)),
                              torch.from_numpy(spl.view(np.int32))).numpy()
        assert got.dtype == np.bool_ and np.array_equal(got, want)
    none = lanes_geq_table(torch.zeros((5, lanes), dtype=torch.int32),
                           torch.zeros((0, lanes), dtype=torch.int32))
    assert none.shape == (5, 0)
