"""Process groups, the rank launcher, state sharding and the collectives of
the multi-device paths. Counterpart of `parallelnbody_tpu/parallel/mesh.py`.

The JAX package runs one program over a device mesh (shard_map over the
"ring" axis). The port runs one process per rank, joined by
torch.distributed; rank r holds particle rows [r*N/P, (r+1)*N/P) and uses
cuda:(r % torch.cuda.device_count()), or the CPU where the caller asks for
it. `RingGroup` is what every function of parallel/ takes in place of the
mesh axis: rank, world size, device, backend and the collectives the paths
use (ring shift = ppermute, tiled all_gather and all_to_all, all_reduce sum,
min and max).

Backend rule: nccl when every rank has a card of its own (world size <=
torch.cuda.device_count()); gloo when ranks share a card, or on the CPU.
Under gloo, tensors on a card are staged through pinned host memory
explicitly, here and nowhere else, and the bytes staged are counted
(`RingGroup.staged_bytes`). Every collective that runs (none at world size
1) is counted by kind in `RingGroup.collectives`. A backend that fails
raises; nothing switches to another backend or device.

Ranks are started by `RankPool` (torch.multiprocessing, spawn) or, for a
run that a launcher such as torchrun starts, joined by `init_distributed`
from the environment. A mesh_shape (ICI,) or (ICI, DCN) gives ICI * DCN
ranks in slice-major order: rank r is position r % ICI of slice r // ICI,
so a ring shift crosses a slice boundary DCN times a rotation.
"""

from __future__ import annotations

import datetime
import os
import queue
import shutil
import tempfile
import time
import traceback
from dataclasses import dataclass, field

import numpy as np
import torch
import torch.distributed as dist

from parallelnbody_tpu_torch.state import SimState, resolve_device

# Collective timeout of the process groups started here (a hung collective
# raises after it); RankPool.run has its own deadline.
GROUP_TIMEOUT = 1800.0
# The name of the ranks' one axis, as the JAX package's mesh names it.
RING_AXIS = "ring"

_OPS = {"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN,
        "max": dist.ReduceOp.MAX}

# Per-rank statistics of the last RankPool.run in this process (launch
# counts, collectives by kind, bytes staged, backend), rank order: the
# CLI's ranks report here.
LAST_RANK_STATS: list = []


def mesh_world_size(mesh_shape) -> int:
    """Ranks of a mesh_shape, () or (P,) or (ICI, DCN)."""
    n = 1
    for s in mesh_shape:
        n *= int(s)
    return n


def backend_for(world_size: int, device) -> str:
    device = torch.device(device)
    if device.type == "cuda" and world_size <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def rank_device(rank: int, device) -> torch.device:
    device = resolve_device(device)
    if device.type == "cuda":
        return torch.device("cuda", rank % torch.cuda.device_count())
    return device


@dataclass
class RingGroup:
    """One rank's view of the process group and its collectives."""

    rank: int
    world_size: int
    device: torch.device
    backend: str
    staged_bytes: int = 0
    # Collectives run, by kind: "all_gather", "all_to_all",
    # "all_reduce:sum" / ":min" / ":max", "shift" (the ring ppermute),
    # "broadcast", "broadcast_object", "gather", "scatter". A call at world
    # size 1 runs none and counts none.
    collectives: dict = field(default_factory=dict)

    def count(self, kind: str):
        self.collectives[kind] = self.collectives.get(kind, 0) + 1

    @property
    def staging(self) -> bool:
        return self.backend == "gloo" and self.device.type == "cuda"

    def _host(self, t):
        if not self.staging:
            return t.contiguous()
        h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        h.copy_(t)
        self.staged_bytes += h.numel() * h.element_size()
        return h

    def _device(self, h):
        if not self.staging:
            return h
        self.staged_bytes += h.numel() * h.element_size()
        return h.to(self.device)

    def all_gather(self, t):
        """Concatenation along dim 0 of every rank's t, in rank order."""
        if self.world_size == 1:
            return t
        self.count("all_gather")
        h = self._host(t)
        parts = [torch.empty_like(h) for _ in range(self.world_size)]
        dist.all_gather(parts, h)
        return self._device(torch.cat(parts))

    def all_to_all(self, t):
        """Block b of dim 0 (world_size equal blocks) goes to rank b; the
        result holds the blocks received, in source-rank order."""
        if self.world_size == 1:
            return t
        self.count("all_to_all")
        h = self._host(t)
        out = torch.empty_like(h)
        dist.all_to_all_single(out, h)
        return self._device(out)

    def all_reduce(self, t, op: str = "sum"):
        if self.world_size == 1:
            return t
        self.count(f"all_reduce:{op}")
        h = self._host(t).clone()
        dist.all_reduce(h, op=_OPS[op])
        return self._device(h)

    def shift_start(self, t) -> "_Shift":
        """Start sending t to rank + 1 and receiving rank - 1's (the ring
        ppermute); `.wait()` returns the received tensor."""
        if self.world_size == 1:
            return _Shift(self, [], t)
        self.count("shift")
        h = self._host(t)
        recv = torch.empty_like(h)
        ops = [dist.P2POp(dist.isend, h, (self.rank + 1) % self.world_size),
               dist.P2POp(dist.irecv, recv,
                          (self.rank - 1) % self.world_size)]
        return _Shift(self, dist.batch_isend_irecv(ops), recv)

    def broadcast(self, t, src: int = 0):
        if self.world_size == 1:
            return t
        self.count("broadcast")
        h = self._host(t).clone()
        dist.broadcast(h, src)
        return self._device(h)

    def broadcast_object(self, obj, src: int = 0):
        """A picklable object from rank src to every rank."""
        if self.world_size == 1:
            return obj
        self.count("broadcast_object")
        box = [obj]
        dist.broadcast_object_list(
            box, src, device=self.device if self.backend == "nccl" else None)
        return box[0]


class _Shift:
    def __init__(self, group, works, recv):
        self._group, self._works, self._recv = group, works, recv

    def wait(self):
        for w in self._works:
            w.wait()
        return self._recv if not self._works else \
            self._group._device(self._recv)


def _timeout(seconds):
    return datetime.timedelta(seconds=float(seconds))


def _join(rank, world_size, device, backend, timeout, **init) -> RingGroup:
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend {backend!r}: nccl or gloo")
    if device.type == "cuda":
        torch.cuda.set_device(device)
        if backend == "nccl":
            init["device_id"] = device
    elif backend == "nccl":
        raise ValueError("nccl needs CUDA devices")
    else:
        torch.set_num_threads(1)
    dist.init_process_group(backend, rank=rank, world_size=world_size,
                            timeout=_timeout(timeout), **init)
    return RingGroup(rank, world_size, device, backend)


def init_distributed(device="cuda", timeout: float = 1800.0) -> RingGroup:
    """Join a process group started by a launcher (torchrun or the like):
    rank, world size and rendezvous from RANK, WORLD_SIZE, MASTER_ADDR and
    MASTER_PORT (LOCAL_RANK, where set, picks the card). Counterpart of
    `jax.distributed.initialize()`. Raises where a variable is missing or
    the backend cannot start."""
    missing = [k for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR",
                           "MASTER_PORT") if k not in os.environ]
    if missing:
        raise RuntimeError(f"--distributed needs {', '.join(missing)} in the "
                           "environment (as torchrun sets them)")
    rank = int(os.environ["RANK"])
    world_size = int(os.environ["WORLD_SIZE"])
    dev = rank_device(int(os.environ.get("LOCAL_RANK", rank)), device)
    return _join(rank, world_size, dev, backend_for(world_size, dev),
                 timeout, init_method="env://")


def _launch_counts() -> dict:
    from parallelnbody_tpu_torch.ops import bh_kernels, direct_kernels

    return {**bh_kernels.LAUNCHES, **direct_kernels.LAUNCHES}


def to_host(obj):
    """obj with every tensor replaced by a numpy copy (what crosses between
    processes: numpy pickles through the pipe, torch tensors would go
    through shared memory)."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(to_host(x) for x in obj))
    if isinstance(obj, (list, tuple)):
        return type(obj)(to_host(x) for x in obj)
    if isinstance(obj, dict):
        return {k: to_host(v) for k, v in obj.items()}
    return obj


def _rank_main(rank, world_size, device, backend, store_path, timeout, tasks,
               results):
    """Body of one spawned rank: join the group, then run tasks (fn, args)
    as fn(group, *args) until None arrives."""
    try:
        group = _join(rank, world_size, device, backend, timeout,
                      store=dist.FileStore(store_path, world_size))
    except BaseException:  # noqa: BLE001 - reported to the parent
        results.put((rank, "err", traceback.format_exc(), None))
        return
    parent = os.getppid()
    while True:
        try:
            task = tasks.get(timeout=5.0)
        except queue.Empty:
            if os.getppid() != parent:  # the parent died: stop
                break
            continue
        if task is None:
            break
        fn, args = task
        before, staged = _launch_counts(), group.staged_bytes
        group.collectives = {}
        try:
            out = to_host(fn(group, *args))
        except BaseException:  # noqa: BLE001 - reported to the parent
            results.put((rank, "err", traceback.format_exc(), None))
            return
        after = _launch_counts()
        stats = {"launches": {k: after[k] - before[k] for k in after},
                 "collectives": dict(group.collectives),
                 "staged_bytes": group.staged_bytes - staged,
                 "backend": group.backend, "device": str(group.device)}
        results.put((rank, "ok", out, stats))
    dist.destroy_process_group()


class RankError(RuntimeError):
    """A rank raised, died or did not answer in time; the pool is closed."""


class RankPool:
    """world_size spawned ranks joined in one process group, kept for
    several tasks. run(fn, *args) calls fn(group, *args) on every rank (fn a
    module-level function of a module without JAX: spawn imports it again
    in each rank) and returns the results in rank order, tensors as numpy.
    A rank that raises, dies or overruns the timeout closes the pool and
    raises RankError with its traceback. LAST_RANK_STATS holds each rank's
    kernel launches in the last run, its collectives by kind (the counter
    is set to empty as each run starts), the bytes staged and the backend
    (this process's own launch counts do not include them).

    On a card the kernels are built here, before any rank starts, so that
    the ranks never race to build them."""

    def __init__(self, world_size: int, device="cuda", *,
                 timeout: float | None = 600.0):
        device = resolve_device(device)
        if device.type == "cuda":
            from parallelnbody_tpu_torch.kernels import build

            build.build()
        self.world_size = int(world_size)
        self.backend = backend_for(self.world_size, device)
        self.timeout = timeout
        self._dir = tempfile.mkdtemp(prefix="pnb_ranks_")
        ctx = torch.multiprocessing.get_context("spawn")
        self._results = ctx.Queue()
        self._tasks = [ctx.Queue() for _ in range(self.world_size)]
        self._procs = [
            ctx.Process(target=_rank_main, daemon=True, args=(
                r, self.world_size, rank_device(r, device), self.backend,
                os.path.join(self._dir, "store"), GROUP_TIMEOUT, self._tasks[r],
                self._results))
            for r in range(self.world_size)]
        for p in self._procs:
            p.start()

    def run(self, fn, *args, timeout: float | None = None) -> list:
        global LAST_RANK_STATS
        if self._procs is None:
            raise RankError("the rank pool is closed")
        for q in self._tasks:
            q.put((fn, args))
        limit = timeout or self.timeout
        deadline = None if limit is None else time.monotonic() + limit
        outs, stats = [None] * self.world_size, [None] * self.world_size
        pending = set(range(self.world_size))
        while pending:
            left = 1.0 if deadline is None else deadline - time.monotonic()
            if left <= 0:
                self.close()
                raise RankError(f"ranks {sorted(pending)} did not finish "
                                f"{getattr(fn, '__name__', fn)} in time")
            try:
                rank, status, out, st = self._results.get(
                    timeout=min(left, 1.0))
            except queue.Empty:
                dead = [r for r in pending
                        if self._procs[r].exitcode is not None]
                if dead:
                    codes = {r: self._procs[r].exitcode for r in dead}
                    self.close()
                    raise RankError(f"ranks exited without a result: "
                                    f"{codes}") from None
                continue
            if status == "err":
                self.close()
                raise RankError(f"rank {rank} failed:\n{out}")
            outs[rank], stats[rank] = out, st
            pending.discard(rank)
        LAST_RANK_STATS = stats
        return outs

    @property
    def closed(self) -> bool:
        return self._procs is None

    def close(self):
        """Stop the ranks (killing any that do not stop at once)."""
        if self._procs is None:
            return
        for q in self._tasks:
            try:
                q.put(None)
            except (OSError, ValueError):
                pass
        end = time.monotonic() + 10.0
        for p in self._procs:
            p.join(timeout=max(0.0, end - time.monotonic()))
        for p in self._procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=10.0)
        self._procs = None
        shutil.rmtree(self._dir, ignore_errors=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def launch(fn, world_size: int, *args, device="cuda",
           timeout: float | None = 600.0) -> list:
    """fn(group, *args) on world_size fresh ranks; results in rank order
    (timeout None: no deadline, dead ranks and errors still end it)."""
    with RankPool(world_size, device, timeout=timeout) as pool:
        return pool.run(fn, *args)


def make_ring_mesh(n_devices: int | None = None, device="cuda",
                   **kw) -> RankPool:
    """The ring of n_devices ranks, started here (a RankPool; None = one
    rank a card). Counterpart of the JAX package's make_ring_mesh: ring
    position = rank."""
    if n_devices is None:
        n_devices = max(torch.cuda.device_count(), 1)
    return RankPool(n_devices, device, **kw)


def make_multislice_ring_mesh(ici: int, dcn: int, device="cuda",
                              **kw) -> RankPool:
    """The ring of ici * dcn ranks in slice-major order, started here
    through make_ring_mesh: rank r is position r % ici of slice r // ici,
    so a full ring rotation crosses a slice boundary dcn times.
    Counterpart of the JAX package's make_multislice_ring_mesh (whose
    device order on one host is the same contiguous partition)."""
    if ici < 1 or dcn < 1:
        raise ValueError(f"ici {ici} and dcn {dcn} must be at least 1")
    return make_ring_mesh(ici * dcn, device, **kw)


def state_pspecs(axis: str = RING_AXIS) -> SimState:
    """Which SimState fields are sharded over the ranks (`axis`) and which
    are replicated (None): the particle arrays and the scalars."""
    return SimState(pos=axis, vel=axis, mass=axis, acc=axis, pot=axis,
                    time=None, step=None, seed=None)


# ------------------------------------------------------------------- states
def shard_rows(n: int, group: RingGroup) -> slice:
    if n % group.world_size:
        raise ValueError(f"N={n} not divisible by {group.world_size} ranks")
    n_local = n // group.world_size
    return slice(group.rank * n_local, (group.rank + 1) * n_local)


def shard_state(state: SimState, group: RingGroup) -> SimState:
    """This rank's rows [r*N/P, (r+1)*N/P) of a full state, on the group's
    device (the counterpart of `shard_state` / `state_pspecs`: particle
    arrays sharded, time and step replicated)."""
    rows = shard_rows(state.n, group)
    dev = group.device

    def take(t):
        return t[rows].contiguous().to(dev)

    return state._replace(pos=take(state.pos), vel=take(state.vel),
                          mass=take(state.mass), acc=take(state.acc),
                          pot=take(state.pot), time=state.time.to(dev),
                          step=state.step.to(dev))


def _pack(state: SimState):
    return torch.cat([state.pos, state.vel, state.acc, state.mass[:, None],
                      state.pot[:, None]], dim=1)


def _unpack(packed, like: SimState, time_step=None) -> SimState:
    t, s = (like.time, like.step) if time_step is None else time_step
    return like._replace(pos=packed[:, 0:3].contiguous(),
                         vel=packed[:, 3:6].contiguous(),
                         acc=packed[:, 6:9].contiguous(),
                         mass=packed[:, 9].contiguous(),
                         pot=packed[:, 10].contiguous(), time=t, step=s)


def gather_state(state: SimState, group: RingGroup, dst: int = 0):
    """The full state on rank dst (None on the others): every rank's rows
    gathered in rank order, for snapshots and checkpoints."""
    if group.world_size == 1:
        return state
    group.count("gather")
    h = group._host(_pack(state))
    parts = ([torch.empty_like(h) for _ in range(group.world_size)]
             if group.rank == dst else None)
    dist.gather(h, parts, dst=dst)
    if group.rank != dst:
        return None
    return _unpack(group._device(torch.cat(parts)), state)


def scatter_state(state, group: RingGroup, src: int = 0) -> SimState:
    """This rank's rows of the full state that rank src holds (`state` is
    ignored on the others): a resumed checkpoint reaches every rank from
    one reader."""
    dev = group.device
    hdr = torch.zeros(5, dtype=torch.float64, device=dev)
    if group.rank == src:
        hdr = torch.tensor([state.n, state.pos.dtype == torch.float64,
                            state.seed, float(state.time), int(state.step)],
                           dtype=torch.float64, device=dev)
    n, is64, seed, t, s = group.broadcast(hdr, src).tolist()
    dtype = torch.float64 if is64 else torch.float32
    rows = shard_rows(int(n), group)
    like = SimState(*(None,) * 7, seed=int(seed))
    scalars = (torch.tensor(t, dtype=dtype, device=dev),
               torch.tensor(int(s), dtype=torch.int32, device=dev))
    if group.world_size == 1:
        return _unpack(_pack(state).to(dev), like, scalars)
    n_local = rows.stop - rows.start
    group.count("scatter")
    recv = group._host(torch.empty((n_local, 11), dtype=dtype, device=dev))
    chunks = None
    if group.rank == src:
        chunks = [group._host(c.to(dev)) for c in _pack(state).split(n_local)]
    dist.scatter(recv, chunks, src=src)
    return _unpack(group._device(recv), like, scalars)


def numpy_state(state: SimState) -> dict:
    """Host numpy copy of a state's arrays (for results that leave a
    rank)."""
    out = {k: np.asarray(to_host(getattr(state, k)))
           for k in ("pos", "vel", "mass", "acc", "pot", "time", "step")}
    out["seed"] = state.seed
    return out
