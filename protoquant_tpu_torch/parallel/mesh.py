"""Single-controller rank mesh: the counterpart of
``protoquant_tpu/parallel/mesh.py`` and of the ``shard_map`` its programs
run under.

The JAX package runs one SPMD program over a named mesh of devices. Here one
process drives every rank: ``Mesh.run(fn)`` calls ``fn(rank)`` for each rank
of the model axis in a thread of its own (as
``torch.nn.parallel.parallel_apply`` does) and returns the results in rank
order. Inside ``fn`` the rank group (``Mesh.group``) gives the
``jax.lax`` collectives the tensor-parallel path needs: ``axis_index``,
``psum``, ``all_gather`` and ``ppermute``.

Every collective is one rendezvous: each rank leaves its operand, the last
rank to arrive combines them once, in rank order, and every rank takes its
share. The ranks take turns (``run``): one runs while the others wait. A
rank that raises breaks the rendezvous, so the others raise too
(``threading.BrokenBarrierError``) and nothing waits forever; ``run``
re-raises the first rank's error. ``psum`` sums in rank order 0..tp-1.

Ranks that share a device share its current stream (the caller's): the
combine of a collective is enqueued after every rank has enqueued the
producers of its operand, so stream order is all the ordering it needs,
with no cross-stream events. A mesh places ranks on a shared device only
where the caller names it (``devices=["cuda:0"] * tp``, or ``["cpu"] * tp``
in the tests); by default rank r runs on ``cuda:r`` and a machine with fewer
cards raises.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import threading

import torch

from ..utils.config import MeshConfig
from ..utils.device import resolve_device

DATA_AXIS = "data"
MODEL_AXIS = "model"


class RankGroup:
    """The ranks of one mesh axis, with the collectives of ``jax.lax``
    over that axis. Call its collectives from inside ``run`` only, every
    rank in the same order."""

    def __init__(self, devices: list, axis_name: str = MODEL_AXIS):
        self.devices = list(devices)
        self.size = len(self.devices)
        self.axis_name = axis_name
        self._local = threading.local()
        # one lock; a condition per rank, so a turn wakes only its rank
        self._lock = threading.Lock()
        self._turns = [threading.Condition(self._lock) for _ in self.devices]
        self._running = False
        self._turn = 0  # the rank whose thread runs; the others wait
        self._arrived = 0  # ranks in the current rendezvous
        self._done = 0  # ranks whose fn has returned
        self._broken = False
        self._values: list = [None] * self.size
        self._names: list = [None] * self.size
        self._combine = None
        self._results: list = []
        self._pool: concurrent.futures.ThreadPoolExecutor | None = None

    # -- the SPMD region ---------------------------------------------------

    def run(self, fn) -> list:
        """``[fn(0), ..., fn(size - 1)]``, each rank in its own thread, with
        the caller's grad mode and, on each CUDA device, its current
        stream.

        One rank runs at a time: rank 0 up to its first collective, then
        rank 1 up to the same collective, and so on; the last rank to
        arrive combines and hands the turn back to rank 0. PyTorch drops the
        GIL in every op, so ranks running at once would trade it at every
        op (a thread switch each time); taking turns keeps it uncontended,
        at a few switches per collective."""
        with self._lock:
            if self._running:
                raise RuntimeError("RankGroup.run is not re-entrant")
            self._running, self._broken = True, False
            self._turn = self._arrived = self._done = 0
        if self._pool is None:
            self._pool = concurrent.futures.ThreadPoolExecutor(
                self.size, thread_name_prefix=f"rank-{self.axis_name}")
        grad = torch.is_grad_enabled()
        streams = {d: torch.cuda.current_stream(d) for d in set(self.devices)
                   if d.type == "cuda"}

        def rank_main(r: int):
            dev = self.devices[r]
            ctx = (contextlib.ExitStack() if dev.type != "cuda" else
                   _cuda_context(dev, streams[dev]))
            self._local.rank = r
            try:
                with ctx, torch.set_grad_enabled(grad):
                    with self._lock:
                        self._wait_turn(r)
                    out = fn(r)
                with self._lock:
                    self._done += 1
                    if self._arrived:
                        raise RuntimeError(f"rank {r} returned while {self._arrived} "
                                           f"rank(s) wait in {self._names}")
                    self._pass_turn()
                return out
            except BaseException:
                with self._lock:
                    self._broken = True
                    for turn in self._turns:
                        turn.notify()
                raise
            finally:
                self._local.rank = None

        try:
            futures = [self._pool.submit(rank_main, r) for r in range(self.size)]
            concurrent.futures.wait(futures)
        finally:
            with self._lock:
                self._running = False
        errors = [f.exception() for f in futures if f.exception() is not None]
        first = next((e for e in errors if not isinstance(e, threading.BrokenBarrierError)),
                     errors[0] if errors else None)
        if first is not None:
            raise first
        return [f.result() for f in futures]

    def _wait_turn(self, r: int) -> None:
        """Block (with ``_lock`` held) until rank r may run; raise if a rank
        failed meanwhile."""
        while self._turn != r and not self._broken:
            self._turns[r].wait()
        if self._broken:
            raise threading.BrokenBarrierError(f"rank {r}: another rank failed")

    def _pass_turn(self) -> None:
        self._turn = (self._turn + 1) % self.size
        self._turns[self._turn].notify()

    def axis_index(self) -> int:
        """This thread's rank (``jax.lax.axis_index``)."""
        rank = getattr(self._local, "rank", None)
        if rank is None:
            raise RuntimeError("a collective outside RankGroup.run")
        return rank

    def collective(self, value, combine, name: str = "collective"):
        """Every rank passes its ``value`` and the same ``combine``; once all
        have arrived, the last runs ``combine([value_0, ..., value_{size-1}])``,
        which returns one result per rank, and each rank gets its own.
        ``name`` must agree across ranks (a rank in another collective, or
        one that has returned, is a fault)."""
        r = self.axis_index()
        with self._lock:
            if self._done:
                raise RuntimeError(f"rank {r} in {name} while a rank has returned")
            self._values[r], self._names[r] = value, name
            if r == 0:
                self._combine = combine
            self._arrived += 1
            if self._arrived == self.size:
                self._arrived = 0
                self._action()
            self._pass_turn()
            self._wait_turn(r)
            return self._results[r]

    def _action(self) -> None:
        """Runs once per rendezvous, in the last rank to arrive, before any
        rank leaves it."""
        if len(set(self._names)) != 1:
            raise RuntimeError(f"ranks in different collectives: {self._names}")
        results = self._combine(list(self._values))
        if len(results) != self.size:
            raise RuntimeError(f"{self._names[0]}: {len(results)} results for "
                               f"{self.size} ranks")
        self._results = list(results)
        self._values = [None] * self.size

    # -- jax.lax collectives -----------------------------------------------

    def _per_rank(self, t: torch.Tensor) -> list:
        return [t if t.device == d else t.to(d) for d in self.devices]

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum over ranks, added in rank order 0..size-1."""
        def combine(xs):
            total = xs[0]
            for t in xs[1:]:
                total = total + t.to(total.device)
            return self._per_rank(total)
        return self.collective(x, combine, "psum")

    def all_gather(self, x: torch.Tensor, axis: int = 0, tiled: bool = False) -> torch.Tensor:
        """The ranks' tensors in rank order: concatenated along ``axis``
        (``tiled``) or stacked on a new axis there."""
        def combine(xs):
            xs = [t.to(xs[0].device) for t in xs]
            return self._per_rank(torch.cat(xs, axis) if tiled else torch.stack(xs, axis))
        return self.collective(x, combine, "all_gather")

    def ppermute(self, x: torch.Tensor, perm) -> torch.Tensor:
        """Rank ``dst`` gets rank ``src``'s tensor for each (src, dst) of
        ``perm``; a rank that receives nothing gets zeros."""
        pairs = [tuple(p) for p in perm]

        def combine(xs):
            out = [torch.zeros_like(t) for t in xs]
            for src, dst in pairs:
                out[dst] = xs[src].to(self.devices[dst])
            return out
        return self.collective(x, combine, "ppermute")


def _cuda_context(dev: torch.device, stream) -> contextlib.ExitStack:
    stack = contextlib.ExitStack()
    stack.enter_context(torch.cuda.device(dev))
    stack.enter_context(torch.cuda.stream(stream))
    return stack


class Mesh:
    """A (dp, tp) layout of ranks over devices. ``shape`` maps the axis
    names to their sizes, as a JAX ``Mesh``; ``group`` is the model axis's
    rank group and ``run`` its SPMD region."""

    def __init__(self, cfg: MeshConfig, devices: list):
        self.cfg = cfg
        self.axis_names = tuple(cfg.axis_names)
        self.shape = {self.axis_names[0]: cfg.dp, self.axis_names[1]: cfg.tp}
        self.devices = list(devices)
        self.group = RankGroup(self.devices, self.axis_names[1])

    def run(self, fn) -> list:
        return self.group.run(fn)

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={[str(d) for d in self.devices]})"


def _device(d) -> torch.device:
    dev = resolve_device(d)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def make_mesh(cfg: MeshConfig | None = None, devices=None) -> Mesh:
    """A single-controller mesh of ``dp * tp`` ranks. ``devices`` defaults to
    the first ``dp * tp`` CUDA cards, one rank each, and raises where the
    machine has fewer; ranks share a device only where ``devices`` names
    it more than once (``["cuda:0"] * tp``). ``dp > 1`` (replicas) is not
    ported yet."""
    cfg = cfg or MeshConfig()
    n = cfg.dp * cfg.tp
    if cfg.dp != 1:
        raise NotImplementedError("dp > 1 (replicas, each with its own KV pool) is not "
                                  "ported yet; the port's mesh has one replica")
    if devices is None:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < n:
            raise RuntimeError(
                f"a mesh of {n} ranks needs {n} CUDA cards, this machine has {have}; "
                f"name the devices to share one (devices=['cuda:0'] * {n}) or to run "
                f"on the CPU (devices=['cpu'] * {n})")
        devices = [torch.device("cuda", i) for i in range(n)]
    devices = [_device(d) for d in devices]
    if len(devices) != n:
        raise ValueError(f"mesh {cfg.dp}x{cfg.tp} != {len(devices)} devices")
    return Mesh(cfg, devices)


def init_multihost(coordinator: str | None = None, num_processes: int | None = None,
                   process_id: int | None = None):
    """Multi-process bring-up (``torch.distributed`` with NCCL, one card a
    rank) is not ported yet: it waits for a machine with two or more
    cards."""
    raise NotImplementedError("multi-process tensor parallelism (torch.distributed, "
                              "NCCL) is not ported yet; use make_mesh in one process")
