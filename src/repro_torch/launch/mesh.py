"""``DxM`` meshes of processes: the sharded page plane's and training's.

The JAX package's ``make_serving_mesh("DxM")`` lays a ('data', 'model')
mesh over the devices of one process. Here every mesh position is a
process (a rank), and the mesh is the set of ``torch.distributed``
groups those ranks share:

- the world, D * M ranks; rank 0 is the leader, which alone runs the
  control plane and sends every other rank the commands it follows,
  each tagged with the engine it is for (a fleet's replicas share the
  mesh);
- one 'model' group per data index ``d`` (ranks ``d*M .. d*M + M-1``):
  the page store shards over it, and the plane's collectives run in it;
- the D data replicas, which run the same batch (the reference
  replicates the decode batch over 'data' too);
- for training (D > 1), one 'data' group per model index ``m`` (ranks
  ``m, M + m, 2M + m, ...``): the batch rows, FSDP leaves and the
  gradient sums go over it (``distributed/collectives.py``). These
  groups come after the others, so the serving meshes' groups are the
  ones they always were.

Rank ``r`` runs on ``cuda:(r % device_count)``. One rank a card talks
NCCL. Ranks that share a card cannot (NCCL refuses two ranks on one
device), so they talk gloo, which takes CUDA tensors for ``broadcast``
and ``all_reduce`` by staging them through host memory; only the
communication leaves the card. The gather over heads is therefore an
``all_reduce`` sum into a zero-filled buffer, which both backends take.
On the CPU every rank uses gloo. Rank 0 logs the mapping and the
backend, and every group times out after ``TIMEOUT_S`` so that ranks
that diverge fail instead of hanging.

``spawn`` starts the ranks of a mesh from one process and returns what
each returned; the launcher, the tests and ``chip_smoke.py`` share it.

``make_production_mesh`` and ``make_debug_mesh`` (the JAX package's
``launch/mesh.py``) give placeholder meshes: one rank's coordinates and
the axis sizes, with no process group and no device
(``PlaceholderMesh``). A rank's program runs against one as it runs
against a ``ServingMesh``; its collectives move nothing
(``distributed/collectives.py``). The dry run (``launch/dryrun.py``)
traces rank 0's program on meta tensors over one.
"""
from __future__ import annotations

import datetime
import multiprocessing
import os
import queue
import sys
import tempfile
import time
import traceback
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.distributed.collectives import all_gather

TIMEOUT_S = 90.0
_HEADER = 64          # int64 slots of a command's header
_TARGET = _HEADER - 1   # the slot that carries the command's engine index


def parse_mesh(spec: str) -> tuple:
    """``"DxM"`` -> (D, M), with the reference's messages."""
    try:
        d, m = (int(x) for x in spec.lower().split("x"))
    except (AttributeError, TypeError, ValueError):
        raise ValueError(f"--mesh wants DxM (e.g. 1x8), got {spec!r}")
    if d < 1 or m < 1:
        raise ValueError(f"--mesh dims must be >= 1, got {d}x{m}")
    return d, m


@dataclass
class ServingMesh:
    """One rank's view of a ``DxM`` mesh: its place, its device and the
    groups and collectives the sharded page plane and training use."""
    data: int
    model: int
    rank: int
    device: torch.device
    backend: str
    model_group: object = field(repr=False)
    cmd_group: object = field(repr=False)
    data_group: object = field(default=None, repr=False)

    axis_names = ("data", "model")

    @property
    def world(self) -> int:
        return self.data * self.model

    size = world            # the device count, as a JAX mesh names it

    @property
    def idx(self) -> int:
        """This rank's index on the 'model' axis (its shard)."""
        return self.rank % self.model

    def coord(self, axis: str) -> int:
        """This rank's index on ``axis`` ('data' or 'model')."""
        return self.rank // self.model if axis == "data" else self.idx

    def group(self, axis: str):
        return self.data_group if axis == "data" else self.model_group

    def gather_axis(self, t: torch.Tensor, dim: int,
                    axis: str) -> torch.Tensor:
        """The ``axis`` ranks' ``t`` laid side by side along ``dim``."""
        return all_gather(t, dim, self, axis)

    @property
    def is_leader(self) -> bool:
        return self.rank == 0

    @property
    def shape(self) -> dict:
        return {"data": self.data, "model": self.model}

    # ------------------------------------------------ the plane's four
    def pmax(self, t: torch.Tensor) -> torch.Tensor:
        """Elementwise max over the 'model' group, in place."""
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.model_group)
        return t

    def psum(self, t: torch.Tensor) -> torch.Tensor:
        """Elementwise sum over the 'model' group, in place."""
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self.model_group)
        return t

    def gather(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """The 'model' group's shards of ``dim`` laid side by side, shard
        ``idx`` at ``idx``: each rank writes its part into zeros and the
        group sums (exact: every element has one nonzero term)."""
        dim = dim % t.dim()
        n = t.shape[dim]
        shape = list(t.shape)
        shape[dim] = n * self.model
        out = t.new_zeros(shape)
        out.narrow(dim, self.idx * n, n).copy_(t)
        return self.psum(out)

    def broadcast(self, t: torch.Tensor) -> torch.Tensor:
        """The leader's ``t`` to every rank, in place."""
        dist.broadcast(t, src=0)
        return t

    # ------------------------------------------------------- commands
    def send(self, op: int, arrays: Sequence[np.ndarray],
             target: int = 0) -> None:
        """Leader: one command, ``op`` and its integer arrays, for engine
        ``target`` (its index among the engines that share the mesh) to
        every other rank (two broadcasts on the host: header, then
        data)."""
        arrays = [np.asarray(a, np.int64) for a in arrays]
        head = [op, len(arrays)]
        for a in arrays:
            head += [a.ndim, *a.shape]
        if len(head) > _TARGET:
            raise ValueError(f"command {op}: header of {len(head)} slots")
        header = torch.zeros(_HEADER + 1, dtype=torch.int64)
        header[:len(head)] = torch.tensor(head)
        header[_TARGET] = target
        header[-1] = sum(a.size for a in arrays)
        dist.broadcast(header, src=0, group=self.cmd_group)
        if header[-1] > 0:
            body = torch.from_numpy(np.concatenate(
                [a.reshape(-1) for a in arrays]))
            dist.broadcast(body, src=0, group=self.cmd_group)

    def recv(self) -> tuple:
        """Follower: the leader's next ``(target, op, arrays)``."""
        header = torch.zeros(_HEADER + 1, dtype=torch.int64)
        dist.broadcast(header, src=0, group=self.cmd_group)
        head = header.tolist()
        body = np.zeros(0, np.int64)
        if head[-1] > 0:
            t = torch.zeros(head[-1], dtype=torch.int64)
            dist.broadcast(t, src=0, group=self.cmd_group)
            body = t.numpy()
        op, n, i, at, arrays = head[0], head[1], 2, 0, []
        for _ in range(n):
            nd = head[i]
            shape = tuple(head[i + 1:i + 1 + nd])
            i += 1 + nd
            size = int(np.prod(shape, dtype=np.int64))
            arrays.append(body[at:at + size].reshape(shape))
            at += size
        return head[_TARGET], op, arrays

    def agree(self, x: float) -> bool:
        """Whether every rank passed the same ``x`` (a float64; an int
        below 2**53)."""
        t = torch.tensor([x, -x], dtype=torch.float64)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.cmd_group)
        return t[0].item() == x and -t[1].item() == x


class PlaceholderMesh:
    """One rank's view of a mesh that has no processes: the axes' sizes
    (``shape``, in order, e.g. ``{"pod": 2, "data": 16, "model": 16}``)
    and this rank's coordinates on them (default all 0: rank 0). It
    answers what a rank's program asks of a ``ServingMesh``; its
    collectives move nothing and return tensors of their results'
    shapes (``distributed/collectives.py``). Every axis but 'model' is a
    data axis: ``data`` counts the data ranks (pod x data), and a
    reduction over 'data' stands for the pod x data group
    (``group("data")``), while a leaf sharded over 'data' (FSDP) is cut
    over the 'data' axis alone, as ``ShardingRules`` lays it out."""

    placeholder = True
    device = torch.device("meta")

    def __init__(self, shape: dict, coords: Optional[dict] = None):
        self.shape = dict(shape)
        self.axis_names = tuple(self.shape)
        self.coords = {a: 0 for a in self.axis_names}
        self.coords.update(coords or {})
        for a, i in self.coords.items():
            if not 0 <= i < self.shape[a]:
                raise ValueError(f"coordinate {a}={i} outside "
                                 f"{self.shape[a]}")

    def __repr__(self):
        return f"PlaceholderMesh({self.shape}, rank {self.rank})"

    @property
    def data(self) -> int:
        return int(np.prod([self.shape[a] for a in data_axes(self)]))

    @property
    def model(self) -> int:
        return self.shape["model"]

    @property
    def world(self) -> int:
        return int(np.prod(list(self.shape.values())))

    size = world            # the device count, as a JAX mesh names it

    @property
    def rank(self) -> int:
        r = 0
        for a in self.axis_names:
            r = r * self.shape[a] + self.coords[a]
        return r

    @property
    def idx(self) -> int:
        return self.coords["model"]

    @property
    def is_leader(self) -> bool:
        return self.rank == 0

    def coord(self, axis: str) -> int:
        return self.coords[axis]

    def group(self, axis: str) -> tuple:
        """The axes a collective over ``axis`` spans (no process group):
        'data' spans every data axis."""
        return data_axes(self) if axis == "data" else (axis,)

    def gather_axis(self, t: torch.Tensor, dim: int,
                    axis: str) -> torch.Tensor:
        return all_gather(t, dim, self, axis)


def make_production_mesh(*, multi_pod: bool = False) -> PlaceholderMesh:
    """16 x 16 = 256 devices a pod, ('data', 'model'); ``multi_pod`` adds
    a leading 'pod' axis of 2 (a data axis): the reference's production
    meshes, as placeholders (rank 0's view)."""
    if multi_pod:
        return PlaceholderMesh({"pod": 2, "data": 16, "model": 16})
    return PlaceholderMesh({"data": 16, "model": 16})


def make_debug_mesh(data: int = 2, model: int = 2) -> PlaceholderMesh:
    """A small ('data', 'model') placeholder mesh (rank 0's view)."""
    return PlaceholderMesh({"data": data, "model": model})


def data_axes(mesh) -> tuple:
    """Every non-'model' axis is a data (batch) axis, 'pod' included."""
    return tuple(n for n in mesh.axis_names if n != "model")


def make_serving_mesh(spec: str, *, rank: int, init_method: str,
                      device=None) -> ServingMesh:
    """Rank ``rank``'s ``ServingMesh`` for ``spec`` (``DxM``): starts the
    default process group of D * M ranks (meeting at ``init_method``)
    and the mesh's groups. ``device`` (``"cuda"`` or ``"cpu"``) defaults
    to cuda; a cuda rank runs on ``cuda:(rank % device_count)``."""
    d, m = parse_mesh(spec)
    world = d * m
    dev = torch.device(device or "cuda")
    if dev.type == "cuda":
        from repro_torch.device import resolve_device
        resolve_device("cuda")
        n_dev = torch.cuda.device_count()
        dev = torch.device("cuda", rank % n_dev)
        torch.cuda.set_device(dev)
    backend = "nccl" if dev.type == "cuda" and world <= n_dev else "gloo"
    timeout = datetime.timedelta(seconds=TIMEOUT_S)
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world, timeout=timeout)
    model_group = None
    for di in range(d):       # every rank creates every group, in order
        g = dist.new_group(list(range(di * m, di * m + m)),
                           timeout=timeout)
        if di == rank // m:
            model_group = g
    cmd_group = dist.group.WORLD if backend == "gloo" \
        else dist.new_group(backend="gloo", timeout=timeout)
    data_group = None
    for mi in range(m if d > 1 else 0):
        g = dist.new_group(list(range(mi, d * m, m)), timeout=timeout)
        if mi == rank % m:
            data_group = g
    mesh = ServingMesh(d, m, rank, dev, backend, model_group, cmd_group,
                       data_group)
    if rank == 0:
        shared = dev.type == "cuda" and world > n_dev
        where = (f"ranks on cuda:{[r % n_dev for r in range(world)]}"
                 if dev.type == "cuda" else "ranks on the cpu")
        print(f"[mesh] {d}x{m}: {world} rank(s), {where}, backend "
              f"{backend}" + (" (ranks share a card: gloo stages the "
                              "collectives through host memory)"
                              if shared else ""),
              file=sys.stderr, flush=True)
    return mesh


def _rank_main(spec, rank, init_method, device, fn, args, results):
    try:
        mesh = make_serving_mesh(spec, rank=rank, init_method=init_method,
                                 device=device)
        out = fn(mesh, *args)
        results.put((rank, True, out))
    except Exception:
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(spec: str, fn: Callable, *args, device=None,
          timeout_s: float = 900.0,
          store_dir: Optional[str] = None) -> List[object]:
    """Run ``fn(mesh, *args)`` on every rank of a ``DxM`` mesh, each in a
    process of its own, and return their results in rank order. ``fn``
    and ``args`` must pickle (``fn`` a module-level function). The ranks
    meet through a ``file://`` store in ``store_dir`` (by default a
    temporary directory, removed afterwards). When a rank fails, or
    ``timeout_s`` passes, every rank is killed and this raises; no rank
    outlives the call."""
    if store_dir is None:
        with tempfile.TemporaryDirectory(prefix="mesh-") as tmp:
            return _spawn(spec, fn, args, device, timeout_s, tmp)
    return _spawn(spec, fn, args, device, timeout_s, store_dir)


def _spawn(spec, fn, args, device, timeout_s, store_dir) -> list:
    d, m = parse_mesh(spec)
    init = "file://" + os.path.join(store_dir, f"rendezvous-{time.time_ns()}")
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(spec, r, init, device, fn, args, results))
             for r in range(d * m)]
    for p in procs:
        p.start()
    done: dict = {}
    deadline = time.monotonic() + timeout_s
    try:
        while len(done) < len(procs):
            left = deadline - time.monotonic()
            if left <= 0:
                busy = sorted(set(range(len(procs))) - set(done))
                raise TimeoutError(f"mesh {spec}: ranks {busy} still "
                                   f"running after {timeout_s} s")
            try:
                r, ok, out = results.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode is not None and r not in done]
                if dead:
                    time.sleep(1.0)        # its report may still be queued
                    if results.empty():
                        raise RuntimeError(
                            f"mesh {spec}: rank {dead[0]} exited with "
                            f"code {procs[dead[0]].exitcode}")
                continue
            if not ok:
                raise RuntimeError(f"mesh {spec}: rank {r} failed:\n{out}")
            done[r] = out
    finally:
        for p in procs:
            p.join(timeout=10.0 if len(done) == len(procs) else 0.1)
            if p.is_alive():
                p.kill()
                p.join()
    return [done[r] for r in range(len(procs))]
