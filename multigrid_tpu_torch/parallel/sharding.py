"""Ranks of ``torch.distributed`` for the z-slab decomposition.

Twin of ``multigrid_tpu/parallel/sharding.py``.  The reference's only
inter-process strategy is MPI domain decomposition of the cell grid with
ghost exchange (SURVEY.md section 2.3); the JAX package renders it as a
``jax.sharding.Mesh`` over which GSPMD or ``shard_map`` move the planes.
Here every rank is a process of its own, with its own slab of every split
level on its own device, and the exchanges are explicit:

* :class:`Ranks`: world size, rank, the rank's device and the backend,
  with the few communication steps the solver needs (plane exchange with
  the neighbours, sums of scalars in rank order, the gather of a replicated
  level, a broadcast of floats);
* :class:`RankGrid`: the ranks laid out on a grid of split axes (z, or
  z and y), with each rank's coordinates and neighbours;
  :func:`rank_grid_shape` factors a world into that grid as the JAX
  ``make_mesh`` does, and :func:`default_grid` picks the axes as the JAX
  poisson_cube experiment does (z and y from 4 ranks on);
* :func:`launch`: spawns ``n_ranks`` processes of one function of this
  package and returns rank 0's result.

Backends: ``nccl`` when every rank has a card of its own (asking for it
with fewer cards than ranks raises; nothing falls back); ``gloo`` for
ranks on the CPU and for ranks that share one card.  PyTorch's gloo has no
point-to-point transfer of CUDA tensors, so on a card under gloo the
planes travel through pinned host buffers, copied explicitly
(:attr:`Ranks.staged`).

The JAX module's ``wrap_padded`` / ``pad_spec`` / ``padded_len`` have no
counterpart: they exist because a ``jax.Array`` sharding must divide its
axis evenly, and a node grid of ``N p + 1`` planes never divides a
power-of-two device count.  A rank here holds a slab of any length.
"""

from __future__ import annotations

import os
import queue
import tempfile
import time
import traceback
from dataclasses import dataclass, field
from datetime import timedelta
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

BACKENDS = ("nccl", "gloo")


def rank_device(rank: int, device="cuda") -> torch.device:
    """The device of ``rank``: ``cuda:(rank % device_count)``, or the CPU
    when the caller asks for it."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"ranks run on 'cuda' or 'cpu', not {device!r}")
    n = torch.cuda.device_count()
    if n == 0:
        raise RuntimeError("no CUDA device: pass device='cpu' (--device cpu "
                           "--backend gloo) to run the ranks on the CPU")
    return torch.device("cuda", rank % n)


def check_backend(backend: str, n_ranks: int, device="cuda") -> None:
    """Refuse a backend that cannot serve ``n_ranks`` ranks on ``device``:
    ``nccl`` needs a card for every rank."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, not {backend!r}")
    if n_ranks < 1:
        raise ValueError(f"n_ranks must be at least 1, not {n_ranks}")
    if backend == "nccl":
        if torch.device(device).type != "cuda":
            raise ValueError("backend nccl runs on CUDA devices only; use "
                             "--backend gloo for ranks on the CPU")
        cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if cards < n_ranks:
            raise ValueError(
                f"backend nccl needs one card per rank: {n_ranks} ranks, "
                f"{cards} card(s); use --backend gloo to share the cards")


@dataclass
class Posted:
    """A point-to-point step in flight (:meth:`Ranks.post`): the backend's
    requests, the tensors it moves (kept alive until it is finished), the
    staging buffers of the receives, and the clock of a timed step."""

    requests: list
    sends: list
    recvs: list
    recv_t: list
    clock: Optional[list] = None
    unpack: list = field(default_factory=list)


@dataclass
class Ranks:
    """This process's place among the ranks, and the communication steps
    of the decomposed solver.  Build it with :func:`init` (or
    :func:`launch`, which does)."""

    world: int
    rank: int
    device: torch.device
    backend: str
    # seconds of the exchange steps ("stage", "wire", "unstage") when a
    # dict: host clock, each step ending with its copies done; each key
    # starts with ``label`` (a two-stage refresh names its stage there)
    times: Optional[dict] = None
    label: str = ""
    # point-to-point steps made (exchange calls that moved data)
    exchanges: int = 0
    _bufs: dict = field(default_factory=dict, repr=False)

    @property
    def staged(self) -> bool:
        """True when CUDA tensors travel through pinned host buffers (gloo
        on a card)."""
        return self.backend == "gloo" and self.device.type == "cuda"

    def _buf(self, key, like: torch.Tensor) -> torch.Tensor:
        """A pinned host buffer shaped like ``like``, kept for reuse."""
        key = (key, tuple(like.shape), like.dtype)
        buf = self._bufs.get(key)
        if buf is None:
            buf = torch.empty(like.shape, dtype=like.dtype, pin_memory=True)
            self._bufs[key] = buf
        return buf

    # ------------------------------------------------------------ exchange
    def post(self, sends, recvs) -> Optional["Posted"]:
        """Start a point-to-point step: ``sends`` and ``recvs`` are lists of
        ``(peer, tensor)``, every tensor contiguous (a z-range of a slab).
        Stages the sends (gloo on a card: copied to pinned host buffers,
        which waits for the current stream) and posts every send and
        receive together, so that the order of the lists cannot deadlock;
        returns the step for :meth:`finish` (None when there is nothing to
        move).  Until then a send must not change and a receive is not
        written.  On nccl the sends wait for the work queued so far on the
        current stream, and no longer."""
        if not sends and not recvs:
            return None
        self.exchanges += 1
        clock = None
        if self.times is not None:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)   # the pass before
            clock = [time.perf_counter()]
        if self.staged:
            send_t = []
            for i, (peer, t) in enumerate(sends):
                buf = self._buf(("send", i), t)
                buf.copy_(t)          # device to pinned host: synchronous
                send_t.append((peer, buf))
            recv_t = [(peer, self._buf(("recv", i), t))
                      for i, (peer, t) in enumerate(recvs)]
        else:
            send_t, recv_t = sends, recvs
        self._tick(clock, "stage")
        ops = ([dist.P2POp(dist.isend, t, peer) for peer, t in send_t]
               + [dist.P2POp(dist.irecv, t, peer) for peer, t in recv_t])
        return Posted(dist.batch_isend_irecv(ops), sends, recvs, recv_t,
                      clock)

    def finish(self, step: Optional["Posted"]) -> None:
        """Wait for a step of :meth:`post` and unstage its receives into
        their tensors (on nccl the current stream waits for the
        transfers)."""
        if step is None:
            return
        for req in step.requests:
            req.wait()
        self._tick(step.clock, "wire")
        if self.staged:
            for (_, t), (_, buf) in zip(step.recvs, step.recv_t):
                t.copy_(buf)
            self._tick(step.clock, "unstage")

    def exchange(self, sends, recvs) -> None:
        """:meth:`post` and :meth:`finish` in one call."""
        self.finish(self.post(sends, recvs))

    def post_packed(self, sends, recvs) -> Optional["Posted"]:
        """:meth:`post` of tensors that need not be contiguous (a y layer of
        a block, a node plane of a cell layer): each non-contiguous one
        goes through a contiguous buffer on its device, kept for reuse,
        packed here (the step "pack" of :attr:`times`) and unpacked by
        :meth:`finish_packed` ("unpack")."""
        clock = None
        if self.times is not None:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            clock = [time.perf_counter()]

        def packed(kind, i, t):
            if t.is_contiguous():
                return t
            key = ("packed", kind, i, tuple(t.shape), t.dtype, t.device)
            buf = self._bufs.get(key)
            if buf is None:
                buf = torch.empty(t.shape, dtype=t.dtype, device=t.device)
                self._bufs[key] = buf
            return buf

        send_b = []
        for i, (peer, t) in enumerate(sends):
            b = packed("send", i, t)
            if b is not t:
                b.copy_(t)
            send_b.append((peer, b))
        recv_b = [(peer, packed("recv", i, t))
                  for i, (peer, t) in enumerate(recvs)]
        self._tick(clock, "pack")
        step = self.post(send_b, recv_b)
        if step is None:
            return None
        step.unpack = [(t, b) for (_, t), (_, b) in zip(recvs, recv_b)
                       if b is not t]
        return step

    def finish_packed(self, step: Optional["Posted"]) -> None:
        """:meth:`finish` of a step of :meth:`post_packed`, then the
        unpacking of its receives."""
        if step is None:
            return
        self.finish(step)
        clock = None
        if self.times is not None:
            clock = [time.perf_counter()]
        for t, b in step.unpack:
            t.copy_(b)
        self._tick(clock, "unpack")

    def exchange_packed(self, sends, recvs) -> None:
        """:meth:`post_packed` and :meth:`finish_packed` in one call."""
        self.finish_packed(self.post_packed(sends, recvs))

    def _tick(self, clock, step: str) -> None:
        if clock is None:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        key = self.label + step
        self.times[key] = self.times.get(key, 0.0) + now - clock[0]
        clock[0] = now

    # ---------------------------------------------------------- reductions
    def _host_or_device(self, t: torch.Tensor) -> torch.Tensor:
        return t.cpu() if self.staged else t

    def allsum(self, t: torch.Tensor) -> torch.Tensor:
        """Sum of a 0-d tensor over the ranks, added in rank order, so that
        every rank gets the same bits whatever order the backend reduces
        in; a 0-d tensor of ``t``'s dtype on ``t``'s device."""
        if self.world == 1:
            return t
        src = self._host_or_device(t.reshape(1))
        parts = [torch.empty_like(src) for _ in range(self.world)]
        dist.all_gather(parts, src)
        out = parts[0]
        for q in parts[1:]:
            out = out + q
        return out.reshape(()).to(t.device)

    def allmax(self, value: float) -> float:
        """Largest of a float over the ranks."""
        t = torch.tensor([float(value)], dtype=torch.float64,
                         device="cpu" if self.backend == "gloo"
                         else self.device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        return float(t)

    def sum_(self, t: torch.Tensor) -> torch.Tensor:
        """In-place sum of ``t`` over the ranks (the gather of a replicated
        level: each rank fills its own planes and zeros elsewhere, so the
        sum is exact)."""
        if self.world == 1:
            return t
        if self.staged:
            buf = self._buf("sum", t)
            buf.copy_(t)
            dist.all_reduce(buf)
            return t.copy_(buf)
        dist.all_reduce(t)
        return t

    def broadcast_floats(self, values) -> list[float]:
        """Rank 0's ``values`` on every rank."""
        t = torch.tensor([float(v) for v in values], dtype=torch.float64,
                         device="cpu" if self.backend == "gloo"
                         else self.device)
        if self.world > 1:
            dist.broadcast(t, src=0)
        return t.tolist()

    def barrier(self) -> None:
        if self.world > 1:
            dist.barrier()


@dataclass(frozen=True)
class RankGrid:
    """``world`` ranks on a grid of ``shape`` (one extent per split axis:
    ``(nz,)``, or ``(nz, ny)`` for the ('z', 'y') split), row-major:
    rank ``iz ny + iy``."""

    shape: tuple[int, ...]
    rank: int

    def __post_init__(self):
        if not 0 <= self.rank < int(np.prod(self.shape)):
            raise ValueError(f"rank {self.rank} outside a rank grid of "
                             f"{self.shape}")

    @property
    def coords(self) -> tuple[int, ...]:
        return tuple(int(i) for i in np.unravel_index(self.rank, self.shape))

    def neighbor(self, axis: int, side: int) -> Optional[int]:
        """The rank next to this one along ``axis`` below (side 0) or above
        (side 1), or None at the end of the axis."""
        c = list(self.coords)
        c[axis] += 1 if side else -1
        if not 0 <= c[axis] < self.shape[axis]:
            return None
        return int(np.ravel_multi_index(c, self.shape))


def rank_grid_shape(world: int, n_axes: int = 1) -> tuple[int, ...]:
    """The rank grid of ``world`` ranks over ``n_axes`` split axes (1: z;
    2: z and y), factored as the JAX ``make_mesh`` does
    (``multigrid_tpu/parallel/sharding.py:31-36``): ``nz`` is the largest
    divisor of ``world`` not above its square root, ``ny = world / nz``."""
    if world < 1:
        raise ValueError(f"world must be at least 1, not {world}")
    if n_axes == 1:
        return (world,)
    if n_axes != 2:
        raise ValueError(f"ranks split z, or z and y: not {n_axes} axes")
    nz = int(np.floor(np.sqrt(world)))
    while world % nz:
        nz -= 1
    return (nz, world // nz)


def default_grid(world: int) -> tuple[int, ...]:
    """The rank grid the experiments use for ``world`` ranks: the axes of
    the JAX poisson_cube experiment, ('z', 'y') from 4 ranks on, else
    ('z',) (``experiments/poisson_cube.py:118``)."""
    return rank_grid_shape(world, 2 if world >= 4 else 1)


def parse_grid(text: str) -> tuple[int, ...]:
    """``"NZxNY"`` (or ``"N"``) as a rank grid shape."""
    try:
        shape = tuple(int(v) for v in text.lower().split("x"))
    except ValueError:
        raise ValueError(f"a rank grid is NZ or NZxNY, not {text!r}") from None
    if not 1 <= len(shape) <= 2 or min(shape) < 1:
        raise ValueError(f"a rank grid is NZ or NZxNY, not {text!r}")
    return shape


def init(backend: str, world: int, rank: int, init_method: str,
         device="cuda", timeout_s: float = 600.0) -> Ranks:
    """Join the process group (``init_method`` e.g. ``file://<path>`` or
    ``tcp://localhost:<port>``) and bind this process to its device."""
    check_backend(backend, world, device)
    dev = rank_device(rank, device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world, rank=rank,
                            timeout=timedelta(seconds=timeout_s),
                            device_id=dev if backend == "nccl" else None)
    return Ranks(world, rank, dev, backend)


def _rank_main(fn, rank, world, backend, device, init_method, args, kwargs,
               timeout_s, q):
    """One spawned rank: join, run ``fn(ranks, *args, **kwargs)``,
    report."""
    try:
        if torch.device(device).type == "cpu":
            torch.set_num_threads(1)
        ranks = init(backend, world, rank, init_method, device,
                     timeout_s=min(600.0, timeout_s))
        try:
            out = fn(ranks, *args, **kwargs)
        finally:
            dist.destroy_process_group()
        q.put((rank, True, out if rank == 0 else None))
    except BaseException:  # reported to the parent, which raises
        q.put((rank, False, traceback.format_exc()))


def launch(fn: Callable, n_ranks: int, backend: str, device="cuda",
           args: tuple = (), kwargs: Optional[dict] = None,
           timeout_s: float = 1800.0):
    """Run ``fn(ranks, *args, **kwargs)`` on ``n_ranks`` spawned processes,
    one a rank, and return rank 0's result (picklable: plain numbers and
    numpy arrays).  ``fn`` must be a module-level
    function of an importable module (the children import it, and nothing
    of the caller's ``__main__``).  The ranks meet through a file store in
    a fresh temporary directory (no port to pick).  On the card the kernel
    library is built here first, so that no two ranks build it.  Raises
    with the rank's traceback if any rank fails, and stops the others;
    ``timeout_s`` bounds the run and each collective wait."""
    check_backend(backend, n_ranks, device)
    if torch.device(device).type == "cuda":
        from .. import _build

        _build.library()
    ctx = torch.multiprocessing.get_context("spawn")
    q = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        init_method = "file://" + os.path.join(tmp, "store")
        procs = [ctx.Process(target=_rank_main,
                             args=(fn, r, n_ranks, backend, device,
                                   init_method, args, kwargs or {},
                                   timeout_s, q),
                             daemon=True)
                 for r in range(n_ranks)]
        for p in procs:
            p.start()
        results, failure = {}, None
        deadline = time.monotonic() + timeout_s
        try:
            while len(results) < n_ranks and failure is None:
                try:
                    rank, ok, out = q.get(timeout=1.0)
                except queue.Empty:
                    dead = [r for r, p in enumerate(procs)
                            if r not in results and p.exitcode is not None]
                    if dead:
                        failure = (f"rank {dead[0]} exited with code "
                                   f"{procs[dead[0]].exitcode} and no result")
                    elif time.monotonic() > deadline:
                        failure = f"ranks did not finish in {timeout_s} s"
                    continue
                if ok:
                    results[rank] = out
                else:
                    failure = f"rank {rank} failed:\n{out}"
        finally:
            for p in procs:
                if failure is not None and p.is_alive():
                    p.terminate()
                p.join(timeout=30)
                if p.is_alive():
                    p.kill()
                    p.join(timeout=10)
    if failure is not None:
        raise RuntimeError(failure)
    return results[0]
