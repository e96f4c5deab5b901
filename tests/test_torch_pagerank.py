"""PyTorch port, PageRank (``locust_tpu_torch.apps.pagerank``) against the
JAX package on the CPU: ``pagerank``, ``pagerank_prep`` and
``pagerank_step`` on seeded graphs of up to 2,000 nodes with dangling
nodes, to rtol 1e-6 and, since the port adds in XLA's CPU order, bit
for bit; the XLA-order sum alone; the edge-list parser's errors; and the
gather-add's grouping and node schedule, with a Python walk of the
schedule as the CUDA kernel walks it (warp rows by groups, then thread
rows), bit for bit against the CSR walk and JAX's step."""

import torch_threads  # noqa: F401 - first: one torch thread per test process

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from locust_tpu.apps.pagerank import pagerank as jpagerank
from locust_tpu.apps.pagerank import pagerank_prep as jprep
from locust_tpu.apps.pagerank import pagerank_step as jstep
from locust_tpu.plan import PlanError as JPlanError
from locust_tpu.plan.compile import edges_from_bytes as jedges
from locust_tpu_torch.apps.pagerank import _xla_sum, pagerank, pagerank_prep, pagerank_step
from locust_tpu_torch.plan import PlanError
from locust_tpu_torch.plan.compile import edges_from_bytes


def _graph(seed: int, n: int, e: int):
    """Seeded skewed graph; every 7th source id folds onto node 3, so the
    graph has dangling nodes."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, e).astype(np.int32)
    dst = (rng.zipf(1.5, e) % n).astype(np.int32)
    src[src % 7 == 0] = 3
    return src, dst


GRAPHS = [(0, 2000, 9000), (1, 7, 9), (2, 1999, 20000), (3, 33, 100), (4, 500, 800)]


@pytest.mark.parametrize("seed,n,e", GRAPHS)
@pytest.mark.parametrize("iters,damping", [(20, 0.85), (7, 0.5)])
def test_pagerank_equals_jax(seed, n, e, iters, damping):
    src, dst = _graph(seed, n, e)
    want = np.asarray(jpagerank(src, dst, num_nodes=n, num_iters=iters, damping=damping))
    got = pagerank(src, dst, n, iters, damping, device="cpu").numpy()
    assert got.dtype == np.float32 and got.shape == (n,)
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert np.array_equal(got, want)  # the same adds in the same order


@pytest.mark.parametrize("seed,n,e", GRAPHS[:3])
def test_prep_and_step_equal_jax(seed, n, e):
    src, dst = _graph(seed, n, e)
    ranks = np.random.default_rng(seed).random(n).astype(np.float32) / n
    j_inv, j_dang = jprep(src, n)
    t_inv, t_dang = pagerank_prep(src, n, device="cpu")
    assert np.array_equal(t_inv.numpy(), np.asarray(j_inv))
    assert np.array_equal(t_dang.numpy(), np.asarray(j_dang))
    want = np.asarray(jstep(src, dst, ranks, j_inv, j_dang, 0.85, n))
    got = pagerank_step(src, dst, torch.from_numpy(ranks), t_inv, t_dang,
                        torch.tensor(0.85), n).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("n", [1, 31, 32, 33, 1000, 1024, 1025, 32769, 100_000])
def test_xla_order_sum_equals_jnp_sum(n):
    x = (np.random.default_rng(n).random(n).astype(np.float32) / n) * 3
    want = np.float32(jax.jit(jnp.sum)(x))
    assert np.float32(_xla_sum(torch.from_numpy(x))) == want


@pytest.mark.parametrize("corpus", [
    b"0 1 2\n", b"# only a comment\n", b"", b"0 x\n", b"0 -1\n", b"1 0\n3\n",
])
def test_edge_parser_errors_equal_jax(corpus):
    with pytest.raises(JPlanError) as theirs:
        jedges(corpus)
    with pytest.raises(PlanError) as ours:
        edges_from_bytes(corpus)
    assert str(ours.value) == str(theirs.value)


def test_edge_parser_equals_jax():
    corpus = b"# SNAP header\n0 1\n\n 1\t2 \n2 0\r\n7 3\n"
    (js, jd), (ts, td) = jedges(corpus), edges_from_bytes(corpus)
    assert js.tolist() == ts.tolist() and jd.tolist() == td.tolist()
    assert ts.dtype == np.int64


def test_pagerank_runs_on_cuda_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    src, dst = _graph(0, 7, 9)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pagerank(src, dst, 7)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pagerank_prep(src, 7)


# ``csrc/pagerank.cu``'s kSpan (a warp row's group of edges), kUnroll (a
# thread row's edges in flight) and kRowStart (a warp row's start, in
# edges, which sizes the warp pool); a pool warp loads a group's sources
# kAhead + 1 groups of its stream ahead of its adds and gathers their
# contributions kAhead groups ahead (kAhead = 3), across its rows' ends.
WARP_ROW_SPAN, THREAD_ROW_SPAN, WARP_ROW_START = 256, 8, 512
SOURCES_AHEAD, GATHER_AHEAD = 4, 3


def _warp_pool(grouping, warps):
    """The kernel's split of a grid of ``warps`` warps: how many take the
    warp rows (about the longest row's work each, rows counted with a
    start of ``WARP_ROW_START`` edges, at most the warp rows' share of
    the edges, at least one, and one warp left for the thread rows), the
    rest taking the thread rows."""
    off, rows = grouping.offsets.numpy().astype(np.int64), grouping.warp_rows
    if rows == 0:
        return 0
    warp_edges, num_edges, longest = off[rows], off[-1], off[1] - off[0]
    share = warps * warp_edges // num_edges if num_edges > 0 else warps
    pool = -(-(warp_edges + WARP_ROW_START * rows) // (longest + WARP_ROW_START))
    pool = max(1, min(pool, share, rows))
    return min(pool, warps - 1) if warps > 1 else pool


def _schedule_walk(init, grouping, ranks, inv_deg, warps=12):
    """What ``csrc/pagerank.cu`` walks, in Python, on a grid of ``warps``
    warps: first every source's contribution, rounded to float32 (no
    per-edge product); then each warp of the warp pool takes its warp
    rows round robin, every other round backwards, as one stream of
    groups of ``WARP_ROW_SPAN`` edges (each row's groups in order, then
    the next row's): a group's sources loaded ``SOURCES_AHEAD`` groups
    of the stream before its adds, their contributions gathered
    ``GATHER_AHEAD`` groups before, only the edges before the row's end
    read, the group's live edges added in order, and a row's total
    written after its last group; and the other warps' threads take the
    thread rows, each gathering its sources' contributions
    ``THREAD_ROW_SPAN`` edges at a time, each add predicated on the row's
    length.  Every edge reads one contribution.  Row ``i`` is node
    ``schedule[i]``; each total is written once."""
    off = grouping.offsets.numpy().astype(np.int64)
    src, sched = grouping.src_by_dst.numpy(), grouping.schedule.numpy()
    r = ranks.numpy()
    d = np.ones_like(r) if inv_deg is None else inv_deg.numpy()  # r * 1.0 is r
    n, rows = len(sched), grouping.warp_rows
    contrib = r * d
    total = np.full(n, np.nan, np.float32)
    pool = _warp_pool(grouping, warps)

    def write(i, acc):
        assert np.isnan(total[sched[i]])
        total[sched[i]] = acc

    for w in range(pool):
        # The warp's stream: (row, its edges of the group, last group of the row).
        stream = []
        for rnd in range(-(-rows // pool)):
            i = rnd * pool + (w if rnd % 2 == 0 else pool - 1 - w)
            if i >= rows:
                break
            for lo in range(off[i], max(off[i + 1], off[i] + 1), WARP_ROW_SPAN):
                stream.append((i, range(lo, min(lo + WARP_ROW_SPAN, off[i + 1])),
                               lo + WARP_ROW_SPAN >= off[i + 1]))
        sources, values = {}, {}
        for k in range(min(SOURCES_AHEAD, len(stream))):
            sources[k] = [src[e] for e in stream[k][1]]
        for k in range(min(GATHER_AHEAD, len(stream))):
            values[k] = [contrib[s] for s in sources.pop(k)]
        acc = np.float32(init)
        for k, (i, edges, last) in enumerate(stream):
            if k + SOURCES_AHEAD < len(stream):
                sources[k + SOURCES_AHEAD] = [src[e] for e in stream[k + SOURCES_AHEAD][1]]
            if k + GATHER_AHEAD < len(stream):
                values[k + GATHER_AHEAD] = [contrib[s]
                                            for s in sources.pop(k + GATHER_AHEAD)]
            assert len(values[k]) == len(edges)
            for c in values.pop(k):
                acc = acc + c
            if last:
                write(i, acc)
                acc = np.float32(init)
        assert not sources and not values
    first = pool if pool < warps else 0  # a grid of one warp takes both
    pool_threads = 32 * (warps - first)
    for t in range(pool_threads):
        for i in range(rows + t, n, pool_threads):
            acc, length = np.float32(init), int(off[i + 1] - off[i])
            for done in range(0, length, THREAD_ROW_SPAN):
                for k in range(THREAD_ROW_SPAN):
                    if k < length - done:
                        acc = acc + contrib[src[off[i] + done + k]]
            write(i, acc)
    assert not np.isnan(total).any()
    return torch.from_numpy(total)


def _check_gather_add(src, dst, n, inv_src=None, seed=0):
    """The gather-add's plain versions (``index_add_`` in the grouping's
    order, the CPU wrapper's; the CSR walk as explicit adds, the card
    check's reference) and the schedule's walk give the JAX step's
    scatter-add bits.  ``inv_src`` (default ``src``) is the full source
    column the inverse degrees come from, as in the pool's epochs over a
    dst-restricted subset."""
    import importlib

    from locust_tpu_torch.apps.pagerank import pagerank_grouping
    from locust_tpu_torch.ops.kernels.pagerank import csr_walk_reference, gather_add

    port = importlib.import_module("locust_tpu_torch.apps.pagerank")
    inv_src = src if inv_src is None else inv_src
    ranks = np.random.default_rng(seed).random(n).astype(np.float32) / n
    inv_deg, dangling = pagerank_prep(inv_src, n, device="cpu")
    grouping = pagerank_grouping(src, dst, n, device="cpu")
    init = torch.tensor(np.float32(0.25) / np.float32(n))
    r = torch.from_numpy(ranks)
    got = gather_add(init, *grouping, r, inv_deg)
    walk = csr_walk_reference(init, *grouping, r, inv_deg)
    sched = _schedule_walk(init, grouping, r, inv_deg)
    assert all(torch.equal(_schedule_walk(init, grouping, r, inv_deg, warps), sched)
               for warps in (1, 2, 5))
    direct = init.expand(n).clone().index_add_(
        0, torch.from_numpy(dst).long(), r[src] * inv_deg[src])
    assert torch.equal(got, walk) and torch.equal(got, direct) and torch.equal(got, sched)
    j_inv, j_dang = jprep(inv_src, n)
    want = np.asarray(jstep(src, dst, ranks, j_inv, j_dang, 0.85, n))
    step = pagerank_step(src, dst, r, inv_deg, dangling, torch.tensor(0.85), n,
                         grouping).numpy()
    assert np.array_equal(step, want)
    # The step through the schedule's walk, as the card runs it.
    orig = port.gather_add
    try:
        port.gather_add = lambda i, o, s, sc, w, rk, iv: _schedule_walk(
            i, port.Grouping(o, s, sc, w), rk, iv)
        walked = pagerank_step(src, dst, r, inv_deg, dangling, torch.tensor(0.85), n,
                               grouping).numpy()
    finally:
        port.gather_add = orig
    assert np.array_equal(walked, want)
    return grouping


def _row_lengths_graph(lengths, seed=6):
    """One destination row per entry of ``lengths`` (node i has
    ``lengths[i]`` in-edges), edges shuffled so each row's edge order is
    not its source order; node 0 has no out-edge (dangling)."""
    rng = np.random.default_rng(seed)
    n = len(lengths)
    dst = np.repeat(np.arange(n), lengths).astype(np.int32)
    rng.shuffle(dst)
    src = rng.integers(1, n, len(dst)).astype(np.int32)
    return src, dst, n


def _hub_graph():
    """A hub with 2,500 in-edges over 3,000 skewed edges of 300 nodes."""
    src, dst = _graph(7, 300, 3000)
    dst[np.random.default_rng(7).permutation(3000)[:2500]] = 11
    return src, dst, 300


def _dst_subset_graph():
    """The pool's epoch shape: a rank shard's edges (dst in the first
    quarter of the nodes) over all 2,000 nodes, so most rows are empty;
    the inverse degrees come from the full source column."""
    src, dst = _graph(0, 2000, 9000)
    keep = dst < 500
    return src[keep], dst[keep], 2000, src


SPECIAL = {
    "hub": _hub_graph,
    # Rows at the edges of a chunk (32), of a thread row's step (8), of a
    # warp row's group (256) and of two groups (512).
    "chunk_edges": lambda: _row_lengths_graph(
        [0, 1, 31, 32, 33, 64, 65, 7, 8, 9, 255, 256, 257, 511, 512, 513, 769, 0, 2]),
    # Rows of three and four groups and one edge either side, at the
    # reach of the pool warp's loads (its gathers three groups ahead, its
    # sources four); node 0 dangling.
    "pipeline_edges": lambda: _row_lengths_graph(
        [0, 767, 768, 769, 1023, 1024, 1025, 3], seed=9),
    "one_node": lambda: (np.zeros(3, np.int32), np.zeros(3, np.int32), 1),
    "seven_nodes": lambda: _row_lengths_graph([3, 0, 70, 1, 0, 65, 5], seed=8),
}


@pytest.mark.parametrize("case", [*(f"graph{i}" for i in range(len(GRAPHS))), *SPECIAL,
                                  "dst_subset"])
def test_gather_add_plain_versions_equal_jax_step(case):
    """The gather-add's two plain versions and the walk of its schedule
    give the JAX step's scatter-add bits: on the seeded graphs, a hub row
    of 2,500 in-edges, rows of 0, 1, 31, 32, 33, 64, 65 ... 769 edges, rows
    of 767 ... 1,025 edges, one node and seven, and a dst-restricted
    subset (most rows empty)."""
    inv_src = None
    if case.startswith("graph"):
        seed, n, e = GRAPHS[int(case[5:])]
        src, dst = _graph(seed, n, e)
    elif case == "dst_subset":
        src, dst, n, inv_src = _dst_subset_graph()
    else:
        src, dst, n = SPECIAL[case]()
    from locust_tpu_torch.ops.kernels.pagerank import WARP_ROW_THRESHOLD

    grouping = _check_gather_add(src, dst, n, inv_src)
    deg = np.bincount(dst, minlength=n)
    assert grouping.warp_rows == int((deg > WARP_ROW_THRESHOLD).sum())
    if case in ("hub", "chunk_edges", "pipeline_edges", "seven_nodes"):
        assert grouping.warp_rows > 0 and grouping.warp_rows < n
    if case == "dst_subset":
        assert (deg == 0).sum() >= 1500


def test_in_edge_grouping_is_stable():
    """Each node's in-edges keep their edge order: one row per node in
    the schedule's order (a stable sort of the edges by their
    destination's schedule position), with CSR offsets over every row, in
    int32 where the graph fits."""
    from locust_tpu_torch.ops.kernels.pagerank import in_edges

    rng = np.random.default_rng(5)
    dst = torch.from_numpy(rng.integers(0, 50, 4000))
    offsets, order, schedule, _ = in_edges(torch.arange(4000), dst, 60)
    assert offsets.dtype == torch.int32 and order.dtype == torch.int32
    deg = np.bincount(dst.numpy(), minlength=60)
    assert offsets.tolist() == [0] + np.cumsum(deg[schedule.numpy()]).tolist()
    for i, v in enumerate(schedule.tolist()):
        row = order[offsets[i]:offsets[i + 1]]
        assert torch.equal(row.long(), torch.nonzero(dst == v).flatten())


@pytest.mark.parametrize("threshold", [0, 1, 8, 32, 100, 10_000])
def test_schedule_covers_every_node_once(threshold):
    """The schedule is a permutation of the nodes, by in-degree largest
    first, ties in node order (a stable sort); its warp rows are its
    first rows, those of more than ``threshold`` in-edges."""
    from locust_tpu_torch.ops.kernels.pagerank import in_edges

    src, dst = _graph(2, 1999, 20000)
    n = 1999
    g = in_edges(torch.from_numpy(src), torch.from_numpy(dst), n, threshold=threshold)
    sched = g.schedule.numpy()
    assert sorted(sched.tolist()) == list(range(n))
    deg = np.bincount(dst, minlength=n)
    assert sched.tolist() == sorted(range(n), key=lambda v: (-deg[v], v))
    assert g.warp_rows == int((deg > threshold).sum())
    assert (deg[sched[:g.warp_rows]] > threshold).all()
    assert (deg[sched[g.warp_rows:]] <= threshold).all()


def test_index_width_is_int32_below_2_to_the_31():
    """int32 indices when ``num_nodes + 1`` and the edge count are below
    2^31, else int64; a grouping forced to int64 holds the same values
    and gives the same sums."""
    from locust_tpu_torch.ops.kernels.pagerank import gather_add, in_edges, index_dtype

    assert index_dtype(2**31 - 2, 2**31 - 1) == torch.int32
    assert index_dtype(2**31 - 1, 5) == torch.int64
    assert index_dtype(5, 2**31) == torch.int64
    assert index_dtype(1, 0) == torch.int32
    src, dst = _graph(3, 33, 100)
    s, d = torch.from_numpy(src), torch.from_numpy(dst)
    g32, g64 = in_edges(s, d, 33), in_edges(s, d, 33, dtype=torch.int64)
    assert {t.dtype for t in g32[:3]} == {torch.int32}
    assert {t.dtype for t in g64[:3]} == {torch.int64}
    assert all(torch.equal(a.long(), b) for a, b in zip(g32[:3], g64[:3]))
    assert g32.warp_rows == g64.warp_rows
    ranks = torch.from_numpy(np.random.default_rng(3).random(33).astype(np.float32))
    inv = torch.from_numpy(np.random.default_rng(4).random(33).astype(np.float32))
    init = torch.tensor(np.float32(0.01))
    assert torch.equal(gather_add(init, *g32, ranks, inv), gather_add(init, *g64, ranks, inv))


@pytest.mark.parametrize("rank", [0, 1])
@pytest.mark.parametrize("graph", ["zipf", "g1003", "dangling"])
def test_gather_add_two_index_spaces_equal_jax_segment_sums(graph, rank):
    """The sharded PageRank's two sums on a world of 2 (tests/
    torch_mesh_rig.py's graphs), where sources and rows are two index
    spaces: the send sum (``npd`` local nodes into ``2 * cap`` send
    slots) and the receive sum (the ``2 * cap`` received slots into the
    ``npd`` local nodes, the dump entries dropped; unweighted, no
    ``inv_deg``).  Both plain versions,
    the walk of the kernel's schedule on grids of 1 to 12 warps and an
    int64 grouping give the bits of JAX's ``segment_sum`` there."""
    import torch_mesh_rig as rig

    from locust_tpu.apps.pagerank import ShardedPageRank as JSharded
    from locust_tpu.parallel.mesh import make_mesh as jmake_mesh
    from locust_tpu_torch.apps.pagerank import ShardedPageRank
    from locust_tpu_torch.ops.kernels.pagerank import Grouping, csr_walk_reference, gather_add
    from locust_tpu_torch.parallel.mesh import Mesh

    n, src, dst = rig.pr_graph(graph)
    sp = ShardedPageRank(Mesh(rank, 2, ("data",), (2,), {"data": None},
                              torch.device("cpu"), "gloo"), n)
    plan = JSharded(jmake_mesh(2), n)._build_plan(src, dst)
    npd, n_slots = sp.npd, 2 * plan["cap"]
    assert npd != n_slots
    send_g, recv_g = sp.groupings(plan)
    rng = np.random.default_rng(rank)
    ranks = rng.random(npd).astype(np.float32) / n
    inv = (1.0 / rng.integers(1, 9, npd)).astype(np.float32)
    recv = rng.random(n_slots).astype(np.float32) / n
    w = ranks[plan["src_l"][rank]] * inv[plan["src_l"][rank]] * plan["mask"][rank]
    want_send = np.asarray(jax.ops.segment_sum(w, plan["send_seg"][rank],
                                               num_segments=n_slots + 1))[:n_slots]
    want_recv = np.asarray(jax.ops.segment_sum(recv, plan["recv_map"][rank].reshape(-1),
                                               num_segments=npd + 1))[:npd]
    zero = torch.zeros(())
    for g, r, i, want in ((send_g, ranks, inv, want_send),
                          (recv_g, recv, None, want_recv)):
        r, i = torch.from_numpy(r), None if i is None else torch.from_numpy(i)
        assert g.offsets.dtype == torch.int32 and g.schedule.shape[0] != r.shape[0]
        g64 = Grouping(*(t.to(torch.int64) for t in g[:3]), g.warp_rows)
        got = gather_add(zero, *g, r, i)
        assert np.array_equal(got.numpy(), want)
        assert torch.equal(csr_walk_reference(zero, *g, r, i), got)
        assert torch.equal(gather_add(zero, *g64, r, i), got)
        for warps in (1, 2, 5, 12):
            assert torch.equal(_schedule_walk(zero, g, r, i, warps), got)


def test_gather_add_sums_over_a_separate_source_space():
    """Five sources into two rows: ``ranks``/``inv_deg`` have the source
    count, the schedule the row count, and the index width counts the
    sources too."""
    from locust_tpu_torch.ops.kernels.pagerank import gather_add, in_edges, index_dtype

    assert index_dtype(10, 10, 2**31) == torch.int64
    g = in_edges(torch.tensor([0, 4, 4]), torch.tensor([1, 1, 0]), 2, num_src=5)
    r = torch.arange(5, dtype=torch.float32)
    got = gather_add(torch.tensor(0.5), *g, r, torch.ones(5))
    assert got.tolist() == [4.5, 4.5]
    assert torch.equal(gather_add(torch.tensor(0.5), *g, r), got)


def test_unweighted_gather_add_equals_a_weight_of_one():
    """No ``inv_deg`` sums the ranks themselves: both plain versions give
    the bits of the same sum weighted by ones (``r * 1.0`` is ``r``)."""
    from locust_tpu_torch.ops.kernels.pagerank import csr_walk_reference, gather_add, in_edges

    rng = np.random.default_rng(11)
    src, dst = rng.integers(0, 50, 400), rng.zipf(1.5, 400) % 20
    g = in_edges(torch.from_numpy(src), torch.from_numpy(dst), 20, threshold=8, num_src=50)
    r = torch.from_numpy(rng.random(50).astype(np.float32))
    init = torch.tensor(np.float32(0.125))
    want = gather_add(init, *g, r, torch.ones(50))
    assert torch.equal(gather_add(init, *g, r), want)
    assert torch.equal(csr_walk_reference(init, *g, r), want)
    assert torch.equal(_schedule_walk(init, g, r, None, 3), want)
