"""The SPMD runtime the port's ``parallel/`` and render graph run on: the
counterparts of the parts of ``jax`` that zenith_tpu/parallel/sharding.py
and the graph's mesh mode use (``Mesh``, ``PartitionSpec``,
``jax.shard_map`` and the ``jax.lax`` collectives ``axis_index``,
``axis_size``, ``ppermute``, ``all_gather``, ``psum`` and ``pmean``).

One thread per shard in one process — the single-controller model of
``jax.shard_map``:

- ``shard_map(body, mesh, in_specs, out_specs)(*args)`` runs ``body`` once
  per shard, each on its own worker thread, with that shard's device
  current. The workers persist across calls (one pool per shard count, its
  calls one at a time), so each thread's CUDA state (its current device,
  cuBLAS handle and workspace) is made once, not every frame.
  ``PartitionSpec(axis)`` splits an input's leading dimension into
  contiguous row bands (shard r gets band r); ``PartitionSpec()``
  replicates it. Outputs combine the same way: a banded output comes back
  as a :class:`ShardedTensor` (the bands where they lie, ``.full()``
  concatenates them), a replicated one as shard 0's value.
- ``axis_index`` is the calling thread's rank. The shards take turns (one
  runs at a time, in rank order, handing on at each collective and at its
  end: see ``_Comm``). Each collective is a rendezvous: every shard posts
  its tensor in its slot, and once all have posted each reads its peers'
  values with ``.to(own_device)``.
- No hang: every wait has a timeout, a shard that raises breaks the
  rendezvous (its peers' waits end at once), and ``shard_map`` re-raises
  the first exception in the caller.

A mesh may put several shards on one device (``default_mesh(4,
device="cuda:0")``, as JAX's ``--xla_force_host_platform_device_count``
puts 8 on the CPU): that runs every collective, halo exchange and
composite on one card. Every shard uses its device's default stream.
Process-wide state that shards touch is guarded in ``ops.runtime``: the
kernels' launch counters by ``STATE_LOCK``, each lazy kernel build by a
lock of its own.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Callable, List, Optional, Sequence

import torch

# A shard waits at most this long at one collective for its peers.
DEFAULT_TIMEOUT_S = 300.0


class Mesh:
    """An ordered tuple of devices along one named axis (the 1-D
    ``jax.sharding.Mesh`` the reference builds): ``mesh.shape[axis]`` is the
    shard count. Hashable, as it keys frame functions."""

    def __init__(self, devices: "Sequence[torch.device | str]", axis: str = "rows"):
        self.devices = tuple(torch.device(d) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        self.axis_names = (axis,)
        self.shape = {axis: len(self.devices)}

    @property
    def size(self) -> int:
        return len(self.devices)

    def __eq__(self, other) -> bool:
        return (isinstance(other, Mesh) and self.devices == other.devices
                and self.axis_names == other.axis_names)

    def __hash__(self) -> int:
        return hash((self.devices, self.axis_names))

    def __repr__(self) -> str:
        return f"Mesh({[str(d) for d in self.devices]}, axis={self.axis_names[0]!r})"


class PartitionSpec(tuple):
    """``PartitionSpec(axis)``: split the leading dimension over ``axis``;
    ``PartitionSpec()``: replicate."""

    def __new__(cls, *names):
        return super().__new__(cls, names)


P = PartitionSpec


class ShardedTensor:
    """A row-banded value: the shards' bands in rank order, each on its
    shard's device. ``full()`` concatenates them on ``device`` (default:
    the first shard's)."""

    def __init__(self, shards: "List[torch.Tensor]"):
        self.shards = list(shards)

    def full(self, device: "Optional[torch.device | str]" = None) -> torch.Tensor:
        dev = torch.device(device) if device is not None else self.shards[0].device
        return torch.cat([s.to(dev) for s in self.shards], dim=0)


class _Comm:
    """The rendezvous of one ``shard_map`` call, and its turns: one shard
    runs at a time, in rank order, and hands the turn on when it reaches a
    collective or its end. Threads that all issue small torch ops at once
    spend their time handing the GIL back and forth (a banded frame on the
    card ran at a quarter of its speed with turns); taking turns costs
    nothing on one card, where the shards' kernels queue on one stream
    anyway, and several cards still overlap their kernels."""

    def __init__(self, n: int, timeout: float):
        self.n = n
        self.timeout = timeout
        self.cv = threading.Condition()
        self.turn = 0
        self.done = [False] * n
        self.slots: List[Any] = [None] * n
        self.arrived = 0
        self.generation = 0
        self.values: list = []
        self.broken = False

    def _wait(self, ready) -> None:
        """Wait (holding ``cv``) until ``ready()``; a timeout or an abort
        breaks the rendezvous for every shard."""
        if not self.cv.wait_for(lambda: self.broken or ready(), self.timeout):
            self.broken = True
            self.cv.notify_all()
        if self.broken:
            raise threading.BrokenBarrierError

    def _hand_on(self, rank: int) -> None:
        """The turn to the next shard after ``rank`` that has not ended."""
        for k in range(1, self.n + 1):
            r = (rank + k) % self.n
            if not self.done[r]:
                self.turn = r
                break
        self.cv.notify_all()

    def begin(self, rank: int) -> None:
        with self.cv:
            self._wait(lambda: self.turn == rank)

    def end(self, rank: int) -> None:
        with self.cv:
            self.done[rank] = True
            self._hand_on(rank)

    def abort(self) -> None:
        with self.cv:
            self.broken = True
            self.cv.notify_all()

    def exchange(self, rank: int, value) -> list:
        with self.cv:
            self.slots[rank] = value
            self.arrived += 1
            generation = self.generation
            if self.arrived == self.n:  # the last to post completes it
                self.values, self.arrived = list(self.slots), 0
                self.generation += 1
                self.turn = self.done.index(False)
                self.cv.notify_all()
            else:
                self._hand_on(rank)
            self._wait(lambda: self.generation > generation and self.turn == rank)
            return self.values


class _ShardContext:
    __slots__ = ("comm", "rank", "axis", "device")

    def __init__(self, comm: _Comm, rank: int, axis: str, device: torch.device):
        self.comm = comm
        self.rank = rank
        self.axis = axis
        self.device = device


_local = threading.local()


def _context(axis_name: str) -> _ShardContext:
    ctx = getattr(_local, "ctx", None)
    if ctx is None:
        raise RuntimeError(f"collective over {axis_name!r} outside shard_map")
    if axis_name != ctx.axis:
        raise NameError(f"unbound axis name {axis_name!r} (the mesh axis is {ctx.axis!r})")
    return ctx


def axis_index(axis_name: str) -> int:
    """This shard's rank along ``axis_name`` (``jax.lax.axis_index``)."""
    return _context(axis_name).rank


def axis_size(axis_name: str) -> int:
    """Shard count along ``axis_name`` (``jax.lax.axis_size``)."""
    return _context(axis_name).comm.n


def current_device() -> torch.device:
    """The device of the calling shard."""
    ctx = getattr(_local, "ctx", None)
    if ctx is None:
        raise RuntimeError("current_device() outside shard_map")
    return ctx.device


def _to(x, device: torch.device, copy: bool = False):
    if isinstance(x, torch.Tensor):
        return x.to(device, copy=copy)
    return x


def ppermute(x, axis_name: str, perm: "Sequence[tuple[int, int]]"):
    """Send ``x`` from ``src`` to ``dst`` for each pair of ``perm``
    (``jax.lax.ppermute``); a shard that no pair sends to gets zeros."""
    ctx = _context(axis_name)
    values = ctx.comm.exchange(ctx.rank, x)
    src = [s for s, d in perm if d == ctx.rank]
    if not src:
        return torch.zeros_like(x)
    return _to(values[src[0]], ctx.device, copy=True)


def all_gather(x, axis_name: str, axis: int = 0, tiled: bool = False):
    """Every shard's ``x`` in rank order (``jax.lax.all_gather``): stacked
    along a new ``axis``, or with ``tiled`` concatenated along it."""
    ctx = _context(axis_name)
    values = [_to(v, ctx.device) for v in ctx.comm.exchange(ctx.rank, x)]
    return torch.cat(values, dim=axis) if tiled else torch.stack(values, dim=axis)


def psum(x, axis_name: str):
    """Sum over the shards, added in rank order (``jax.lax.psum``); a
    Python number sums to a number (``psum(1, axis)`` is the shard count)."""
    ctx = _context(axis_name)
    values = ctx.comm.exchange(ctx.rank, x)
    total = _to(values[0], ctx.device)
    for v in values[1:]:
        total = total + _to(v, ctx.device)
    return total


def pmean(x, axis_name: str):
    """Mean over the shards (``jax.lax.pmean``): ``psum(x) / n``."""
    return psum(x, axis_name) / axis_size(axis_name)


# -- shard_map ---------------------------------------------------------------------


def _leaves_map(fn: Callable, tree):
    """``fn`` on every tensor or other leaf of nested dicts, lists and
    tuples (imports, dynamics, a mip chain's levels)."""
    if isinstance(tree, dict):
        return {k: _leaves_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_leaves_map(fn, v) for v in tree)
    return fn(tree)


def _place(spec: PartitionSpec, tree, rank: int, n: int, device: torch.device):
    """Shard ``rank``'s view of one argument: every tensor in it moved to
    ``device``, and with ``PartitionSpec(axis)`` cut to its row band."""
    banded = len(spec) > 0

    def leaf(x):
        if isinstance(x, ShardedTensor):
            if banded and len(x.shards) == n:
                return x.shards[rank].to(device)
            x = x.full()
        if not isinstance(x, torch.Tensor):
            return x
        if not banded:
            return x.to(device)
        if x.shape[0] % n:
            raise ValueError(f"leading dimension {x.shape[0]} does not divide over {n} shards")
        band = x.shape[0] // n
        return x[rank * band:(rank + 1) * band].to(device)

    return _leaves_map(leaf, tree)


def _combine(spec, results: list):
    """The shards' outputs as one: ``None`` keeps the list, ``P()`` takes
    shard 0's (replicated) value, ``P(axis)`` makes the tensors' bands a
    ``ShardedTensor``, and a tuple of specs combines a tuple output
    element by element."""
    if spec is None:
        return results
    if isinstance(spec, PartitionSpec):
        return ShardedTensor(results) if spec else results[0]
    return tuple(_combine(s, [r[i] for r in results]) for i, s in enumerate(spec))


class _Workers:
    """``n`` daemon threads, each running the tasks posted to its queue in
    order. One ``shard_map`` call at a time (``lock``): interleaved calls
    could leave two calls' shards waiting for each other."""

    def __init__(self, n: int):
        self.lock = threading.Lock()
        self.queues = [queue.SimpleQueue() for _ in range(n)]
        for rank, q in enumerate(self.queues):
            threading.Thread(target=self._serve, args=(q,), name=f"zenith-shard-{rank}",
                             daemon=True).start()

    @staticmethod
    def _serve(q: "queue.SimpleQueue") -> None:
        while True:
            q.get()()


_WORKERS: "dict[int, _Workers]" = {}
_WORKERS_LOCK = threading.Lock()


def _workers(n: int) -> _Workers:
    with _WORKERS_LOCK:
        pool = _WORKERS.get(n)
        if pool is None:
            pool = _WORKERS[n] = _Workers(n)
        return pool


def shard_map(body: Callable, mesh: Mesh, in_specs, out_specs) -> Callable:
    """``jax.shard_map`` on threads: the returned function runs ``body``
    once per shard of ``mesh`` and combines the outputs by ``out_specs``
    (``None``: the list of every shard's output, in rank order)."""
    axis = mesh.axis_names[0]
    n = mesh.size

    def run(*args):
        if getattr(_local, "ctx", None) is not None:
            raise RuntimeError("shard_map inside shard_map is not supported")
        specs = in_specs if isinstance(in_specs, (list, tuple)) and not isinstance(
            in_specs, PartitionSpec) else (in_specs,) * len(args)
        if len(specs) != len(args):
            raise ValueError(f"{len(specs)} in_specs for {len(args)} arguments")
        comm = _Comm(n, DEFAULT_TIMEOUT_S)
        results: list = [None] * n
        errors: "list[Optional[BaseException]]" = [None] * n
        grad = torch.is_grad_enabled()
        done = threading.Semaphore(0)

        def shard(rank: int) -> None:
            dev = mesh.devices[rank]
            _local.ctx = _ShardContext(comm, rank, axis, dev)
            try:
                comm.begin(rank)
                if dev.type == "cuda":
                    torch.cuda.set_device(dev)
                with torch.set_grad_enabled(grad):
                    shard_args = [_place(spec, a, rank, n, dev)
                                  for spec, a in zip(specs, args)]
                    results[rank] = body(*shard_args)
            except BaseException as e:  # noqa: BLE001 - re-raised in the caller
                errors[rank] = e
                comm.abort()
            finally:
                _local.ctx = None
                comm.end(rank)
                done.release()

        pool = _workers(n)
        with pool.lock:
            for rank, q in enumerate(pool.queues):
                q.put(lambda rank=rank: shard(rank))
            for _ in range(n):
                done.acquire()
        raised = [e for e in errors if e is not None]
        if raised:
            first = next((e for e in raised if not isinstance(e, threading.BrokenBarrierError)),
                         raised[0])
            raise first
        return _combine(out_specs, results)

    return run
