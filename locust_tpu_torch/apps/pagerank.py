"""PageRank: iterative MapReduce over an edge list.

Port of ``locust_tpu/apps/pagerank.py``.  Per iteration, map each edge
(s -> d) to the emit ``(d, rank[s]/deg[s])`` and reduce by key with sum,
then apply damping.  Node ids ARE the keys, so the shuffle degenerates
to a dense segment sum into a ``[num_nodes]`` vector — no byte keys, no
sort.  Dangling mass (deg == 0 nodes) redistributes uniformly.  On the
mesh (``locust_tpu_torch.parallel``, one rank per process),
``DistributedPageRank`` shards the edges and replicates the ranks, and
``ShardedPageRank`` shards the ranks too, exchanging pre-aggregated
contributions through one all-to-all per iteration.

Ranks are float32, and the port adds in the order the JAX package's
CPU compile adds, so that on the CPU the ranks are the same bits:

  * the dangling mass is summed as XLA's CPU reduction does
    (``_xla_sum``: windows of 32, each summed in order, the input padded
    with zeros split evenly on both ends, repeated until 32 or fewer
    partial sums remain, which are then summed in order);
  * ``x / num_nodes`` is ``x * f32(1 / num_nodes)``, XLA's rewrite of a
    division by a constant;
  * the contributions are added in edge order onto the dangling share
    ``mass / num_nodes`` (XLA folds that addend into the scatter's
    initial value): ``ops/kernels/pagerank.gather_add`` walks each node's
    in-edges, grouped once per graph into one row per node by a stable
    sort (``pagerank_grouping``), in edge order, each product rounded to
    float32 before its add; on the CPU it
    is ``index_add_``, which adds in index order, and on CUDA the
    gather-add kernel (``csrc/pagerank.cu``), so the card's ranks are the
    CPU's bits too;
  * ``teleport + damping * s`` is one rounding of the exact value, as the
    fused multiply-add XLA's CPU compile emits: the port computes it in
    float64 (the product is exact) and rounds to float32.

The mesh steps add in the order of the JAX package's CPU mesh as well
(tests/test_torch_mesh_apps_pagerank.py finds it): ``psum`` adds the
ranks' values left to right in rank order, so the port gathers them
(``all_gather``, exact) and folds them so on every rank; a float never
goes through ``all_reduce``, whose order neither gloo nor NCCL fixes.
There ``damping`` is a Python constant of the step: the teleport term is
``(1 - damping) / num_nodes`` rounded once from float64, the dangling
share ``mass * f32(1 / num_nodes)`` is added after the contributions,
then the fused multiply-add.
"""

from __future__ import annotations

import numpy as np
import torch

from locust_tpu_torch import obs
from locust_tpu_torch.engine import resolve_device
from locust_tpu_torch.ops.kernels.pagerank import Grouping, gather_add, in_edges
from locust_tpu_torch.parallel.mesh import DATA_AXIS, Mesh

# XLA's CPU compile reduces in windows of this many elements.
_XLA_REDUCE_WINDOW = 32


def _xla_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum a float32 vector in the order of XLA's CPU reduction: explicit
    elementwise adds, so the order is the same on any device."""
    w = _XLA_REDUCE_WINDOW
    while x.shape[0] > w:
        n = x.shape[0]
        pad = -(-n // w) * w - n
        x = torch.nn.functional.pad(x, (pad // 2, pad - pad // 2)).reshape(-1, w)
        acc = x[:, 0]
        for j in range(1, w):
            acc = acc + x[:, j]
        x = acc
    acc = torch.zeros((), dtype=x.dtype, device=x.device)
    for j in range(x.shape[0]):
        acc = acc + x[j]
    return acc


def _edges(a, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(a).to(device=device, dtype=torch.int64)


def edge_column(a):
    """An edge column as a plan's ``edges`` source hands it on: a tensor
    as it is, on its device (a graph held on the card never goes through
    the host), anything else as a numpy array."""
    return a if isinstance(a, torch.Tensor) else np.asarray(a)


def _host_column(a) -> np.ndarray:
    """An edge column on the host, for the mesh's routing plan."""
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def pagerank_prep(src, num_nodes: int, device=None):
    """The loop-invariant state of ``pagerank``: ``(inv_deg, dangling)``
    from the FULL edge source column."""
    dev = resolve_device(device)
    s = _edges(src, dev)
    deg = torch.zeros(num_nodes, dtype=torch.float32, device=dev).index_add_(
        0, s, torch.ones(s.shape[0], dtype=torch.float32, device=dev)
    )
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    inv_deg = torch.where(deg > 0, 1.0 / torch.clamp(deg, min=1.0), zero)
    return inv_deg, deg == 0


def pagerank_grouping(src, dst, num_nodes: int, device=None) -> Grouping:
    """The loop-invariant in-edge grouping ``pagerank_step`` walks
    (``ops/kernels/pagerank.in_edges``): one row per node, in a schedule
    of the nodes by in-degree, largest first, each row its in-edges'
    sources in edge order (a stable sort), with the rows' CSR offsets
    and how many of them take a warp each."""
    dev = resolve_device(device)
    return in_edges(_edges(src, dev), _edges(dst, dev), num_nodes)


def pagerank_step(src, dst, ranks: torch.Tensor, inv_deg: torch.Tensor,
                  dangling: torch.Tensor, damping, num_nodes: int,
                  grouping=None) -> torch.Tensor:
    """ONE ``pagerank`` iteration, on ``ranks``'s device.  ``damping`` is
    a float32 operand, never a Python float: ``(1 - damping) / n`` is
    computed in float32, as the JAX package's traced operand is (a
    float64 constant would change the low bits).  ``grouping`` is
    ``pagerank_grouping(src, dst, num_nodes)``, built here when None."""
    dev = ranks.device
    if grouping is None:
        grouping = pagerank_grouping(src, dst, num_nodes, dev)
    damping = torch.as_tensor(damping, dtype=torch.float32).to(dev)
    inv_n = torch.tensor(np.float32(1) / np.float32(num_nodes), device=dev)
    teleport = (1.0 - damping) * inv_n
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    mass = _xla_sum(torch.where(dangling, ranks, zero))
    total = gather_add(mass * inv_n, *grouping, ranks.contiguous(), inv_deg)
    return (teleport.double() + damping.double() * total.double()).float()


def pagerank(src, dst, num_nodes: int, num_iters: int = 20,
             damping: float = 0.85, device=None) -> torch.Tensor:
    """Single-device PageRank over edge arrays ``[E]`` (numpy or tensors):
    ``num_iters`` damped power iterations from uniform ranks; float32
    ranks ``[num_nodes]`` on the device.  Pass valid edges only (no
    padding).  Runs on CUDA unless ``device`` says otherwise.  With the
    tracer on, spans ``pagerank.prep``, ``pagerank.grouping`` and one
    ``pagerank.iteration`` a step, and the counter
    ``pagerank.iterations``; no span adds a wait for the card."""
    dev = resolve_device(device)
    s, d = _edges(src, dev), _edges(dst, dev)
    with obs.span("pagerank.prep"):
        inv_deg, dangling = pagerank_prep(s, num_nodes, dev)
    # Ends at the grouping's own read of its warp-row count.
    with obs.span("pagerank.grouping"):
        grouping = pagerank_grouping(s, d, num_nodes, dev)
    damping = torch.tensor(damping, dtype=torch.float32, device=dev)
    ranks = torch.full((num_nodes,), 1.0 / num_nodes, dtype=torch.float32, device=dev)
    for _ in range(num_iters):
        with obs.span("pagerank.iteration"):
            ranks = pagerank_step(s, d, ranks, inv_deg, dangling, damping, num_nodes, grouping)
        obs.metric_inc("pagerank.iterations")
    return ranks


def _fold_ranks(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """``psum`` of a float tensor as the JAX CPU mesh adds it: every rank's
    value gathered (exact), then added left to right in rank order, the
    same on every rank."""
    parts = mesh.all_gather(x.reshape(1, -1), axis)
    acc = parts[0]
    for p in parts[1:]:
        acc = acc + p
    return acc.reshape(x.shape)


def _mesh_damp(contrib: torch.Tensor, mass: torch.Tensor, num_nodes: int,
               damping: float) -> torch.Tensor:
    """``(1 - damping) / num + damping * (contrib + mass / num)`` as the
    JAX mesh step compiles on the CPU: the teleport term from float64,
    ``mass * f32(1 / num)`` added after the contributions, one rounding
    of ``teleport + damping * s``."""
    dev = contrib.device
    teleport = float(np.float32((1.0 - damping) / num_nodes))
    inv_n = torch.tensor(np.float32(1) / np.float32(num_nodes), device=dev)
    s = contrib + mass * inv_n
    return (teleport + float(np.float32(damping)) * s.double()).float()


def _world_axis(mesh: Mesh, axis: str) -> int:
    """The ranks along ``axis``, which must span the world: rank ``r`` of
    the world holds shard ``r``."""
    n = int(mesh.shape[axis])
    if n != mesh.size:
        raise ValueError(f"the PageRank mesh apps shard over the whole world: axis "
                         f"{axis!r} has {n} ranks, the world {mesh.size}")
    return n


def _np_inv_deg(deg: np.ndarray) -> np.ndarray:
    return np.where(deg > 0, 1.0 / np.maximum(deg, 1.0), 0.0)


class DistributedPageRank:
    """Edge-sharded PageRank on a mesh: a local gather-add and an exact
    combine.

    The mesh/axis contract matches ``DistributedMapReduce``; ranks and
    degrees are replicated (dense ``[num_nodes]`` vectors on every rank),
    edges shard along the axis in equal slices (the last padded).  A
    rank's partial is the gather-add of its valid edges onto 0 (the
    padded edges, whose mask is 0, add nothing and are left out of its
    grouping); the partials are gathered and folded in rank order.
    """

    def __init__(self, mesh: Mesh, num_nodes: int, axis_name: str = DATA_AXIS,
                 damping: float = 0.85):
        self.mesh = mesh
        self.num_nodes = num_nodes
        self.axis = axis_name
        self.damping = damping
        self.n_dev = _world_axis(mesh, axis_name)

    def run(self, src: np.ndarray, dst: np.ndarray, num_iters: int = 20) -> np.ndarray:
        """Float32 ranks ``[num_nodes]`` as host numpy, on every rank."""
        num, mesh = self.num_nodes, self.mesh
        dev = mesh.device
        src, dst = np.asarray(src), np.asarray(dst)
        deg = np.bincount(src, minlength=num).astype(np.float32)
        inv_deg = torch.from_numpy(_np_inv_deg(deg).astype(np.float32)).to(dev)
        dangling = torch.from_numpy(deg == 0).to(dev)
        # This rank's slice of the edges padded to equal slices.
        e = len(src)
        per = -(-e // self.n_dev)
        lo, hi = min(mesh.rank * per, e), min((mesh.rank + 1) * per, e)
        grouping = in_edges(_edges(src[lo:hi], dev), _edges(dst[lo:hi], dev), num)
        zero = torch.zeros((), dtype=torch.float32, device=dev)
        ranks = torch.full((num,), 1.0 / num, dtype=torch.float32, device=dev)
        for _ in range(num_iters):
            partial = gather_add(zero, *grouping, ranks, inv_deg)
            contrib = _fold_ranks(partial, mesh, self.axis)
            mass = _xla_sum(torch.where(dangling, ranks, zero))
            ranks = _mesh_damp(contrib, mass, num, self.damping)
        return ranks.cpu().numpy()


class ShardedPageRank:
    """Node-partitioned PageRank: rank state sharded, not replicated.

    Rank ``d`` owns the contiguous node block ``[d*npd, (d+1)*npd)`` and
    holds only its rank/degree block, its edge shard (grouped by source
    owner) and fixed-size send/receive buffers.  The graph is static, so
    the routing plan (``_build_plan``, the JAX package's numpy) is built
    once on the host, and each iteration is: the send sum (the gather-add
    of the rank's edges into one static slot per (destination shard,
    distinct destination node)), one all-to-all of the slots, the receive
    sum (the gather-add of the received slots, sender-major, into the
    local nodes, the dump entries dropped), and the damping, with the
    dangling mass summed locally and folded over the ranks in order.
    Because slots are per distinct destination node, capacity is exact:
    no skew overflow, no drop or retry path.
    """

    def __init__(self, mesh: Mesh, num_nodes: int, axis_name: str = DATA_AXIS,
                 damping: float = 0.85):
        if num_nodes < 1:
            raise ValueError(f"num_nodes must be >= 1, got {num_nodes}")
        self.mesh = mesh
        self.num_nodes = num_nodes
        self.axis = axis_name
        self.damping = damping
        self.n_dev = _world_axis(mesh, axis_name)
        self.npd = -(-num_nodes // self.n_dev)  # nodes per device (padded)

    def _build_plan(self, src: np.ndarray, dst: np.ndarray) -> dict:
        """Static routing plan, per-device arrays (leading axis = device):
        one lexsort over (owner, dest_shard, dst) plus run-length
        boundaries.  A dst's slot id is its rank among the distinct dsts
        of its (owner, dest_shard) pair.  Padded edge slots scatter to the
        dump slot ``n_dev * cap``, unused receive entries to ``npd``."""
        n_dev, npd = self.n_dev, self.npd
        src = np.asarray(src, np.int64).ravel()
        dst = np.asarray(dst, np.int64).ravel()
        owner = src // npd
        dest = dst // npd
        n_edges = src.shape[0]

        order = np.lexsort((dst, dest, owner))
        src, dst, owner, dest = src[order], dst[order], owner[order], dest[order]
        counts = np.bincount(owner, minlength=n_dev)
        starts = np.concatenate([[0], np.cumsum(counts)])
        e_max = max(1, int(counts.max()))

        if n_edges:
            # Run starts: first edge of each distinct (owner, dest, dst);
            # pair starts: first edge of each (owner, dest) group.
            same_run = (
                (owner[1:] == owner[:-1])
                & (dest[1:] == dest[:-1])
                & (dst[1:] == dst[:-1])
            )
            new_run = np.concatenate([[True], ~same_run])
            pair_change = np.concatenate(
                [[True], (owner[1:] != owner[:-1]) | (dest[1:] != dest[:-1])]
            )
            run_id = np.cumsum(new_run) - 1
            pair_id = np.cumsum(pair_change) - 1
            pair_first_run = run_id[pair_change]          # [n_pairs]
            rank = run_id - pair_first_run[pair_id]       # dst rank in pair
            n_pairs = int(pair_id[-1]) + 1
            nuniq = np.bincount(pair_id[new_run], minlength=n_pairs)
            cap = max(1, int(nuniq.max()))
        else:
            rank = np.zeros(0, np.int64)
            cap = 1
        cap = -(-cap // 8) * 8  # the JAX package's lane-aligned payload

        src_l = np.zeros((n_dev, e_max), np.int32)        # src local id
        mask = np.zeros((n_dev, e_max), np.float32)
        # Padded (and only padded) edge slots scatter to the dump slot.
        send_seg = np.full((n_dev, e_max), n_dev * cap, np.int32)
        recv_map = np.full((n_dev, n_dev, cap), npd, np.int32)  # npd = dump
        if n_edges:
            col = np.arange(n_edges) - starts[owner]      # slot within device
            src_l[owner, col] = (src - owner * npd).astype(np.int32)
            mask[owner, col] = 1.0
            send_seg[owner, col] = (dest * cap + rank).astype(np.int32)
            # Receiver p's map for sender d: slot -> its local node id,
            # one entry per distinct (owner, dest, dst) run.
            r_owner, r_dest = owner[new_run], dest[new_run]
            recv_map[r_dest, r_owner, rank[new_run]] = (
                dst[new_run] - r_dest * npd
            ).astype(np.int32)

        return dict(
            src_l=src_l, mask=mask, send_seg=send_seg, recv_map=recv_map,
            cap=cap, e_max=e_max,
        )

    def groupings(self, plan: dict) -> tuple[Grouping, Grouping]:
        """This rank's two static groupings, on its device: the send sum's
        (its valid edges, local source node -> send slot; ``n_dev * cap``
        rows over ``npd`` sources) and the receive sum's (the received
        slots, sender-major, -> local node; ``npd`` rows over ``n_dev *
        cap`` sources, the dump entries dropped)."""
        d, dev = self.mesh.rank, self.mesh.device
        n_slots = self.n_dev * plan["cap"]
        valid = plan["mask"][d] > 0
        send = in_edges(_edges(plan["src_l"][d][valid], dev),
                        _edges(plan["send_seg"][d][valid], dev), n_slots, num_src=self.npd)
        rmap = plan["recv_map"][d].reshape(-1)
        keep = np.flatnonzero(rmap < self.npd)
        recv = in_edges(_edges(keep, dev), _edges(rmap[keep], dev), self.npd, num_src=n_slots)
        return send, recv

    def run(self, src, dst, num_iters: int = 20) -> np.ndarray:
        """Float32 ranks ``[num_nodes]`` as host numpy, gathered onto every
        rank; the edges numpy arrays or tensors on any device."""
        from locust_tpu_torch.parallel.mesh import gather_host_array

        n_dev, npd, num, mesh = self.n_dev, self.npd, self.num_nodes, self.mesh
        dev, d = mesh.device, mesh.rank
        src, dst = _host_column(src), _host_column(dst)
        plan = self._build_plan(src, dst)
        cap = plan["cap"]

        # Node-block-local static vectors, as the JAX package builds them.
        deg = np.bincount(np.asarray(src), minlength=n_dev * npd).astype(np.float32)
        inv_deg = _np_inv_deg(deg)
        node_valid = (np.arange(n_dev * npd) < num).astype(np.float32)
        dangling = ((deg == 0) & (node_valid > 0)).astype(np.float32)
        ranks0 = (node_valid / num).astype(np.float32)

        def mine(x):
            return torch.from_numpy(np.ascontiguousarray(
                x.reshape(n_dev, npd)[d], np.float32)).to(dev)

        inv_deg_l, dangling_l, valid_l, ranks = (
            mine(inv_deg), mine(dangling), mine(node_valid), mine(ranks0))
        send_g, recv_g = self.groupings(plan)
        zero = torch.zeros((), dtype=torch.float32, device=dev)
        for _ in range(num_iters):
            # (r * i) * mask is r * i on a valid edge, and 0.0 + a is a.
            send = gather_add(zero, *send_g, ranks, inv_deg_l)
            recv = mesh.all_to_all(send.reshape(n_dev, cap), self.axis).reshape(-1)
            contrib = gather_add(zero, *recv_g, recv.contiguous())
            mass = _fold_ranks(_xla_sum(ranks * dangling_l), mesh, self.axis)
            ranks = valid_l * _mesh_damp(contrib, mass, num, self.damping)
        return gather_host_array(ranks, mesh, None).reshape(-1)[:num]
