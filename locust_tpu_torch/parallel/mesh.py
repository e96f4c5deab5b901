"""The process world and its mesh: ``torch.distributed``, one rank per process.

Port of ``locust_tpu/parallel/mesh.py``.  The JAX package runs one
program over a ``jax.sharding.Mesh`` of devices; the port runs one
process per rank, each holding its shard, and the collectives of
``torch.distributed`` stand in for the mesh's: the shuffle's all-to-all,
the stats' sums and maxima, the result's gather.

* ``initialize_multihost(coordinator, num_processes, process_id)`` joins
  the world (``init_process_group`` over ``tcp://coordinator``), the
  CLI's ``--coordinator/--num-processes/--process-id``; a collective
  whose peer died ends after ``COLLECTIVE_TIMEOUT``.  Without it,
  ``make_mesh`` makes a world of one rank in the calling process.
* The rank's device is ``cuda:(process_id % device_count)`` unless the
  caller asks for the CPU (``device="cpu"``, the CLI's ``--backend
  cpu``); with no card and no CPU asked for, it raises.
* The backend: NCCL when each rank has a card of its own; gloo when ranks
  share a card (NCCL refuses two ranks on one GPU) or run on the CPU.
  Every rank publishes its card (host name and card UUID) in the
  coordinator's store before the group forms, so ranks on different hosts
  with one card each pick NCCL and every rank reaches the same answer.
  Under gloo a card's tensors go through the host: ``.cpu()`` before the
  collective, ``.to(device)`` after it.
* ``Mesh`` names its axes as the JAX mesh does: ``("data",)`` for
  ``make_mesh``, ``("slice", "data")`` for ``make_mesh_2d``, whose ranks
  are slice-major (rank ``s * D + d``); each axis has the process group
  of this rank's line along it, made with ``new_group`` by every rank in
  the same order.
* ``shard_rows`` gives each rank its ``[rank * per, (rank + 1) * per)``
  rows of a host-replicated round (the reference's per-node ``[start,
  end)`` line contract, main.cu:47-54); ``scatter_host_array`` slices any
  host-replicated array the same way; ``gather_host_array`` gathers every
  rank's shard onto every rank, as ``process_allgather`` does.
"""

from __future__ import annotations

import dataclasses
import datetime
import socket
import time

import numpy as np
import torch
import torch.distributed as dist

from locust_tpu_torch import obs
from locust_tpu_torch.engine import resolve_device

DATA_AXIS = "data"
SLICE_AXIS = "slice"

# Set by initialize_multihost: the device this process's rank runs on.
_rank_device: torch.device | None = None

# A rank whose peer never reaches a collective (a crashed peer) ends the
# wait after this long instead of the backend's default half hour.
COLLECTIVE_TIMEOUT = datetime.timedelta(seconds=600)


# What this process's collectives moved: calls, bytes sent and the host's
# wall seconds per kind (staging through the host included; an axis of one
# rank calls nothing and counts nothing).  The all-to-alls are also counted
# in the tracer's ``mesh.all_to_all_calls`` and ``mesh.all_to_all_bytes``.
COMM = {kind: {"calls": 0, "bytes": 0, "s": 0.0}
        for kind in ("all_to_all", "all_reduce", "all_gather")}


def _count(kind: str, t: torch.Tensor, t0: float) -> None:
    _count_bytes(kind, t.numel() * t.element_size(), t0)


def _count_bytes(kind: str, nbytes: int, t0: float) -> None:
    c = COMM[kind]
    c["calls"] += 1
    c["bytes"] += nbytes
    c["s"] += time.perf_counter() - t0


def free_port() -> int:
    """A free TCP port on the loopback interface."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def coordinator_store(num_processes: int, host: str = "127.0.0.1") -> dist.TCPStore:
    """Rank 0's store, listening on a port the system picks (no window in
    which another process can take it); ``store.port`` is the port the
    other ranks' ``host:port`` coordinator names."""
    return dist.TCPStore(host, 0, num_processes, True, timeout=COLLECTIVE_TIMEOUT,
                         wait_for_workers=False)


def card_identity(device: torch.device) -> str | None:
    """The physical card a rank runs on, unique across hosts (None on the
    CPU)."""
    if device.type != "cuda":
        return None
    uuid = getattr(torch.cuda.get_device_properties(device), "uuid", device.index)
    return f"{socket.gethostname()}/{uuid}"


def pick_backend(cards: list) -> str:
    """NCCL when every rank runs on a card of its own, gloo when a rank runs
    on the CPU or two ranks share a card.  ``cards`` holds every rank's
    ``card_identity``."""
    if any(c is None for c in cards):
        return "gloo"
    return "nccl" if len(set(cards)) == len(cards) else "gloo"


def _exchange_cards(store, num_processes: int, process_id: int, card: str | None) -> list:
    """Every rank's card, read from the store each rank wrote its own to."""
    cards = dist.PrefixStore("locust/card/", store)
    cards.set(str(process_id), "" if card is None else card)
    return [cards.get(str(r)).decode() or None for r in range(num_processes)]


def _rank_device_for(device, process_id: int) -> torch.device:
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", process_id % torch.cuda.device_count())
    return dev


def initialize_multihost(coordinator_address: str, num_processes: int, process_id: int,
                         device=None, store=None) -> torch.device:
    """Join the process world; returns this rank's device.  Every process
    runs this with the same coordinator (``host:port``, where process 0
    listens) and count, and its own id.  Process 0 may pass the store it
    already listens on (``coordinator_store``)."""
    global _rank_device
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError("a process world needs its coordinator, its number of "
                         "processes and this process's id")
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process_id {process_id} outside a world of {num_processes}")
    dev = _rank_device_for(device, process_id)
    if dev.type == "cuda":
        # The rank's card is the process's current device: a bare "cuda"
        # (and its memory statistics) means that card.
        torch.cuda.set_device(dev)
    if store is None:
        host, port = coordinator_address.rsplit(":", 1)
        store = dist.TCPStore(host, int(port), num_processes, process_id == 0,
                              timeout=COLLECTIVE_TIMEOUT, wait_for_workers=False)
    backend = pick_backend(_exchange_cards(store, num_processes, process_id,
                                           card_identity(dev)))
    kw = {"device_id": dev} if backend == "nccl" else {}
    dist.init_process_group(backend, store=store, world_size=num_processes, rank=process_id,
                            timeout=COLLECTIVE_TIMEOUT, **kw)
    _rank_device = dev
    return dev


def shutdown() -> None:
    """Leave the process world (``destroy_process_group``), if joined."""
    global _rank_device
    if dist.is_initialized():
        dist.destroy_process_group()
    _rank_device = None


def _ensure_world(device) -> torch.device:
    """The joined world's rank device; a world of one rank in this
    process when none is joined yet."""
    if not dist.is_initialized():
        store = coordinator_store(1)
        return initialize_multihost(f"127.0.0.1:{store.port}", 1, 0, device, store)
    if device is not None:
        dev = resolve_device(device)
        if _rank_device is not None and dev.type != _rank_device.type:
            raise ValueError(f"the process world runs on {_rank_device}, not {dev}")
    return _rank_device if _rank_device is not None else _rank_device_for(device, dist.get_rank())


@dataclasses.dataclass(eq=False)
class Mesh:
    """This rank's view of the mesh: its global rank, the axes (names and
    sizes, major first), its process group along each axis, its device
    and the world's backend."""

    rank: int
    size: int
    axis_names: tuple[str, ...]
    axis_sizes: tuple[int, ...]
    groups: dict
    device: torch.device
    backend: str

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))

    def group(self, axis: str):
        return self.groups[axis]

    def axis_size(self, axis: str | None) -> int:
        """Ranks along ``axis`` (the whole world when None)."""
        return self.size if axis is None else self.axis_sizes[self.axis_names.index(axis)]

    # ---- collectives; a card's tensors go through the host under gloo.
    # Along an axis of one rank each is the identity and calls nothing
    # (so a world of one's background checkpoint writer never issues a
    # collective beside the round loop's).

    def _out(self, t: torch.Tensor) -> torch.Tensor:
        return t.cpu() if self.backend == "gloo" else t

    def _back(self, t: torch.Tensor) -> torch.Tensor:
        return t if t.device == self.device else t.to(self.device, non_blocking=True)

    def all_to_all(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """Block ``i`` of ``x``'s first dimension goes to the ``i``-th rank
        along ``axis``; block ``i`` of the result came from it."""
        if self.axis_size(axis) == 1:
            return x
        t0 = time.perf_counter()
        send = self._out(x).contiguous()
        recv = torch.empty_like(send)
        dist.all_to_all_single(recv, send, group=self.group(axis))
        out = self._back(recv)
        _count("all_to_all", send, t0)
        obs.metric_inc("mesh.all_to_all_calls")
        obs.metric_inc("mesh.all_to_all_bytes", send.numel() * send.element_size())
        return out

    def all_to_all_v(self, blocks: list[torch.Tensor], recv_rows: list[int],
                     axis: str) -> torch.Tensor:
        """Block ``i`` of ``blocks`` (contiguous, any number of rows of one
        shape and dtype) goes to the ``i``-th rank along ``axis``, which
        sends this rank ``recv_rows[i]`` rows.  Returns what arrived as one
        dense tensor, sender-major.  NCCL takes the blocks as they are and
        receives into views of one buffer; gloo refuses unequal blocks in
        that form, so the blocks are joined (on the host, where gloo stages
        anyway) and split by sizes.  Counted as one all-to-all of the
        blocks' bytes, this rank's own block included."""
        if self.axis_size(axis) == 1:
            return blocks[0]
        t0 = time.perf_counter()
        group = self.group(axis)
        sizes = [b.shape[0] for b in blocks]
        if self.backend == "gloo":
            send = torch.cat([self._out(b) for b in blocks])
            recv = send.new_empty((sum(recv_rows), *send.shape[1:]))
            dist.all_to_all_single(recv, send, recv_rows, sizes, group=group)
            out = self._back(recv)
        else:
            first = blocks[0]
            out = first.new_empty((sum(recv_rows), *first.shape[1:]))
            dist.all_to_all(list(out.split(recv_rows)), [b.contiguous() for b in blocks],
                            group=group)
        nbytes = sum(b.numel() * b.element_size() for b in blocks)
        _count_bytes("all_to_all", nbytes, t0)
        obs.metric_inc("mesh.all_to_all_calls")
        obs.metric_inc("mesh.all_to_all_bytes", nbytes)
        return out

    def all_reduce(self, x: torch.Tensor, axis: str, op: str = "sum") -> torch.Tensor:
        """Elementwise sum (or max) of ``x`` over the ranks along ``axis``."""
        if self.axis_size(axis) == 1:
            return x
        t0 = time.perf_counter()
        buf = self._out(x).clone()
        dist.all_reduce(buf, op=dist.ReduceOp.SUM if op == "sum" else dist.ReduceOp.MAX,
                        group=self.group(axis))
        out = self._back(buf)
        _count("all_reduce", buf, t0)
        return out

    def all_gather(self, x: torch.Tensor, axis: str | None = None) -> torch.Tensor:
        """Every rank's ``x`` along ``axis`` (the whole world when None),
        concatenated on the first dimension in rank order."""
        n = self.axis_size(axis)
        if n == 1:
            return x
        t0 = time.perf_counter()
        group = None if axis is None else self.group(axis)
        send = self._out(x).contiguous()
        parts = [torch.empty_like(send) for _ in range(n)]
        dist.all_gather(parts, send, group=group)
        out = self._back(torch.cat(parts))
        _count("all_gather", send, t0)
        return out


def make_mesh(n_devices: int | None = None, axis_name: str = DATA_AXIS, device=None) -> Mesh:
    """1-D mesh over the process world (a world of one rank in this process
    when none is joined).  ``n_devices`` must be the world's size: a mesh
    spans every rank."""
    dev = _ensure_world(device)
    world = dist.get_world_size()
    n = world if n_devices is None else n_devices
    if n > world:
        raise ValueError(f"requested {n} devices, have {world}")
    if n != world:
        raise ValueError(f"a mesh spans the whole process world ({world} ranks); "
                         f"requested {n}")
    return Mesh(dist.get_rank(), world, (axis_name,), (world,), {axis_name: None}, dev,
                dist.get_backend())


def make_mesh_2d(n_slices: int, devs_per_slice: int | None = None,
                 slice_axis: str = SLICE_AXIS, data_axis: str = DATA_AXIS,
                 device=None) -> Mesh:
    """2-D ``[slice, data]`` mesh for the hierarchical engine: rank ``s * D
    + d`` is device ``d`` of slice ``s``.  Its ``data`` group holds a
    slice's ranks (the per-round shuffle), its ``slice`` group the ranks
    of one data index across slices (the final combine)."""
    dev = _ensure_world(device)
    world = dist.get_world_size()
    if devs_per_slice is None:
        if world % n_slices:
            raise ValueError(f"{world} devices do not divide into {n_slices} slices")
        devs_per_slice = world // n_slices
    need = n_slices * devs_per_slice
    if need > world:
        raise ValueError(f"requested {need} devices, have {world}")
    if need != world:
        raise ValueError(f"a mesh spans the whole process world ({world} ranks); "
                         f"requested {need}")
    rank = dist.get_rank()
    groups = {}
    # Every rank creates every group, in the same order.
    for s in range(n_slices):
        g = dist.new_group([s * devs_per_slice + d for d in range(devs_per_slice)])
        if rank // devs_per_slice == s:
            groups[data_axis] = g
    for d in range(devs_per_slice):
        g = dist.new_group([s * devs_per_slice + d for s in range(n_slices)])
        if rank % devs_per_slice == d:
            groups[slice_axis] = g
    return Mesh(rank, world, (slice_axis, data_axis), (n_slices, devs_per_slice), groups, dev,
                dist.get_backend())


def scatter_host_array(arr, mesh: Mesh) -> torch.Tensor:
    """This rank's equal share of a host-replicated array, split on its
    first dimension in rank order, on the rank's device."""
    arr = np.asarray(arr)
    if arr.shape[0] % mesh.size:
        raise ValueError(f"global row count {arr.shape[0]} must divide evenly over "
                         f"{mesh.size} processes")
    per = arr.shape[0] // mesh.size
    return torch.from_numpy(np.ascontiguousarray(arr[mesh.rank * per:(mesh.rank + 1) * per])
                            ).to(mesh.device)


def gather_host_array(x: torch.Tensor, mesh: Mesh, axis: str | None = None) -> np.ndarray:
    """Every rank's shard (along ``axis``; the whole world when None),
    concatenated in rank order, as host numpy on every rank.  bool
    tensors travel as uint8."""
    is_bool = x.dtype == torch.bool
    out = mesh.all_gather(x.to(torch.uint8) if is_bool else x, axis).cpu().numpy()  # locust: noqa[R003] a loop reaches it only through a checkpoint snapshot: one host copy per checkpoint_every rounds, what the writer persists
    return out.astype(bool) if is_bool else out


def shard_rows(rows: np.ndarray, mesh: Mesh) -> torch.Tensor:
    """This rank's rows of a round: ``rows`` is the GLOBAL ``[n, width]``
    host array, the same on every process; rank ``r`` takes rows ``[r *
    n / size, (r + 1) * n / size)`` onto its device."""
    return scatter_host_array(rows, mesh)
