"""A (rays, blocks) mesh of ranks over `torch.distributed`.

Port of `gradient_sdf_tpu/parallel/mesh.py`. The JAX package runs one
controller over a 2-D device mesh (`shard_map`); here every mesh position
is a process of its own (a rank), the SPMD form PyTorch runs on, and the
collectives go through `torch.distributed`. The axes keep their names and
order: `RAY_AXIS` (pixels / rays data-parallel) and `BLOCK_AXIS` (the
grid's per-voxel storage sharded by block), laid out as an
[n // block_parallel, block_parallel] array of ranks, rank r at
(r // block_parallel, r % block_parallel) unless the caller gives the
layout (`distributed.global_mesh` puts hosts on the block axis).

Placement and backend follow fixed rules, printed when the group starts:
rank r runs on `cuda:(LOCAL_RANK % torch.cuda.device_count())`, or on the
CPU when the caller asks for it; the backend is NCCL when every local rank
has a card of its own, gloo otherwise (NCCL refuses two ranks on one card;
on one card four ranks share it under gloo, and such a run says so). A
failed rendezvous raises; there is no fallback to the CPU or to one rank.

Collectives: only `all_reduce` and `broadcast`, the two that gloo offers on
CUDA tensors. `psum_scatter_rows` is an all_reduce after which the rank
keeps its own rows; `all_gather_rows` is an all_reduce of a buffer that
holds this rank's rows and -0.0 elsewhere (x + -0.0 is x, bit for bit,
for every float x, so an assembled tensor equals its sources exactly).
Every collective adds one to `calls` and its payload to `nbytes`, like the
kernels' launch counters.

`launch(fn, n, *args)` spawns n local ranks (spawn start method, a
`FileStore` rendezvous in a fresh temporary directory, so concurrent
launches never race for a port) and returns rank 0's return value.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import pickle
import shutil
import tempfile
import time
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

RAY_AXIS = "rays"
BLOCK_AXIS = "blocks"
WORLD = (RAY_AXIS, BLOCK_AXIS)

# a replicated decision that differs between ranks leaves the others waiting
# in a collective: the group's timeout turns that into an error
DEFAULT_TIMEOUT_S = 300.0

# collectives since the last reset_counts(), and their payload in bytes;
# check_replicated's collectives are not counted
calls = 0
nbytes = 0


def reset_counts():
    global calls, nbytes
    calls = 0
    nbytes = 0


def backend_for(device, local_world_size: int) -> str:
    """NCCL when every local rank has a card of its own, gloo otherwise."""
    if torch.device(device).type != "cuda":
        return "gloo"
    return "nccl" if local_world_size <= torch.cuda.device_count() else "gloo"


def rank_device(device, local_rank: int) -> torch.device:
    """This rank's device: `cuda:(local_rank % cards)` for a CUDA request,
    the CPU for a CPU one; raises when CUDA is asked for and absent."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"ranks run on cuda or cpu, not {device!r}")
    n = torch.cuda.device_count()
    if n == 0:
        raise RuntimeError(f"device {str(device)!r}: CUDA is not available")
    return torch.device("cuda", local_rank % n)


def init_group(rank: int, world_size: int, local_rank: int,
               local_world_size: int, device="cuda", *, store=None,
               init_method: Optional[str] = None,
               timeout_s: float = DEFAULT_TIMEOUT_S) -> str:
    """Join the process group (one call per rank); returns the backend.
    Rank 0 prints the backend, the cards and the ranks per card."""
    backend = backend_for(device, local_world_size)
    dev = rank_device(device, local_rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend, store=store, init_method=init_method, rank=rank,
        world_size=world_size,
        timeout=datetime.timedelta(seconds=timeout_s))
    if rank == 0:
        print(placement(backend, dev, local_world_size), flush=True)
    return backend


def placement(backend: str, dev: torch.device, local_world_size: int) -> str:
    if dev.type != "cuda":
        return (f"process group: {local_world_size} local ranks on the CPU, "
                f"backend {backend}")
    cards = torch.cuda.device_count()
    used = min(cards, local_world_size)
    per = -(-local_world_size // cards)
    shared = (" (the ranks SHARE a card: no multi-card result)"
              if per > 1 else "")
    return (f"process group: {local_world_size} local ranks on {used} of "
            f"{cards} cards ({torch.cuda.get_device_name(dev)}), {per} "
            f"rank(s) per card, backend {backend}{shared}")


@dataclasses.dataclass
class Mesh:
    """This rank's view of the (rays, blocks) mesh."""

    layout: np.ndarray        # int [n_rays, n_blocks] of world ranks
    rank: int
    ray_index: int            # this rank's row: its position on RAY_AXIS
    block_index: int          # its column: its position on BLOCK_AXIS
    device: torch.device
    backend: str
    world: object             # process groups: all ranks,
    rays: object              # the ranks of this column (vary along rays),
    blocks: object            # the ranks of this row (vary along blocks)

    @property
    def size(self) -> int:
        return int(self.layout.size)

    @property
    def shape(self) -> Tuple[int, int]:
        return tuple(self.layout.shape)

    def axis_size(self, axes) -> int:
        axes = _axes(axes)
        return int(np.prod([self.layout.shape[0 if a == RAY_AXIS else 1]
                            for a in axes]))

    def axis_index(self, axes) -> int:
        """Position along `axes`; over both it is rays-major, the order
        JAX gives a P((rays, blocks)) shard, i.e. the rank's flat index."""
        axes = _axes(axes)
        if axes == (RAY_AXIS,):
            return self.ray_index
        if axes == (BLOCK_AXIS,):
            return self.block_index
        return self.ray_index * self.layout.shape[1] + self.block_index

    def group(self, axes):
        axes = _axes(axes)
        if axes == (RAY_AXIS,):
            return self.rays
        if axes == (BLOCK_AXIS,):
            return self.blocks
        return self.world

    def ranks_per_card(self) -> int:
        if self.device.type != "cuda":
            return 0
        local = int(os.environ.get("LOCAL_WORLD_SIZE", self.size))
        return -(-local // torch.cuda.device_count())

    def describe(self) -> str:
        r, b = self.shape
        return f"{self.size} devices ({r} rays x {b} blocks)"


def _axes(axes) -> Tuple[str, ...]:
    if isinstance(axes, str):
        axes = (axes,)
    axes = tuple(axes)
    for a in axes:
        if a not in WORLD:
            raise ValueError(f"unknown mesh axis {a!r}")
    return tuple(a for a in WORLD if a in axes)


def make_mesh(n_devices: Optional[int] = None, block_parallel: int = 1,
              device="cuda", *, layout: Optional[np.ndarray] = None) -> Mesh:
    """Build the (rays, blocks) mesh over the ranks of the process group.

    `n_devices` (default: the world size) must be the world size: a rank
    is a device. `block_parallel` divides it; the rest go to the ray axis.
    Every rank must call this, in the same order as every other group
    creation: the row and column groups are created here."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: start the ranks "
                           "with parallel.mesh.launch or join one with "
                           "parallel.distributed.init")
    world = dist.get_world_size()
    n = world if n_devices is None else int(n_devices)
    if n != world:
        raise ValueError(f"a mesh of {n} devices in a group of {world} ranks")
    if block_parallel < 1 or n % block_parallel:
        raise ValueError(f"block_parallel {block_parallel} does not divide "
                         f"{n} devices")
    if layout is None:
        layout = np.arange(n).reshape(n // block_parallel, block_parallel)
    layout = np.asarray(layout)
    if layout.shape[1] != block_parallel or sorted(layout.ravel()) != list(range(n)):
        raise ValueError(f"layout {layout.tolist()} is no [n // "
                         f"{block_parallel}, {block_parallel}] array of ranks")
    rank = dist.get_rank()
    rows = [dist.new_group([int(r) for r in row]) for row in layout]
    cols = [dist.new_group([int(r) for r in col]) for col in layout.T]
    (i,), (j,) = np.nonzero(layout == rank)
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    return Mesh(layout=layout, rank=rank, ray_index=int(i), block_index=int(j),
                device=rank_device(device, local_rank),
                backend=dist.get_backend(), world=dist.group.WORLD,
                rays=cols[j], blocks=rows[i])


# ---------------------------------------------------------------------------
# collectives (all_reduce and broadcast only)
# ---------------------------------------------------------------------------


def _count(x: torch.Tensor):
    global calls, nbytes
    calls += 1
    nbytes += x.numel() * x.element_size()


def psum(x: torch.Tensor, mesh: Mesh, axes=WORLD, *, op=dist.ReduceOp.SUM,
         count: bool = True) -> torch.Tensor:
    """All-reduce `x` (contiguous) IN PLACE over `axes`; returns x."""
    if mesh.axis_size(axes) == 1:
        return x
    if not x.is_contiguous():
        raise ValueError("collectives take contiguous tensors")
    dist.all_reduce(x, op=op, group=mesh.group(axes))
    if count:
        _count(x)
    return x


def psum_scatter_rows(x: torch.Tensor, mesh: Mesh, axis: str,
                      sum_axes=None) -> torch.Tensor:
    """JAX `psum_scatter(x, axis, tiled=True)`: the sum over `sum_axes`
    (default `axis`) of `x` [k * m, ...], of which this rank keeps rows
    [i * m, (i + 1) * m), i its position along `axis` (k its size). One
    all_reduce: the whole sum moves."""
    k, i = mesh.axis_size(axis), mesh.axis_index(axis)
    if x.shape[0] % k:
        raise ValueError(f"{x.shape[0]} rows over {k} ranks")
    psum(x, mesh, axis if sum_axes is None else sum_axes)
    m = x.shape[0] // k
    return x[i * m:(i + 1) * m]


def all_gather_rows(x: torch.Tensor, mesh: Mesh, axes,
                    n: Optional[int] = None) -> torch.Tensor:
    """JAX `all_gather(x, axes, tiled=True)`: every rank's rows stacked in
    rank order along `axes`, on every rank. `x` is this rank's
    `shard_rows(n, mesh, axes)` part of n rows (default: k times its own,
    an even split). One all_reduce of an [n, ...] buffer holding this
    rank's rows and -0.0 elsewhere (integers: 0), which reproduces every
    source value bit for bit."""
    k = mesh.axis_size(axes)
    if k == 1:
        return x
    n = k * x.shape[0] if n is None else n
    rows = shard_rows(n, mesh, axes)
    if rows.stop - rows.start != x.shape[0]:
        raise ValueError(f"{x.shape[0]} rows, this rank's part of {n} is "
                         f"{rows.stop - rows.start}")
    fill = -0.0 if x.is_floating_point() else 0
    buf = torch.full((n,) + tuple(x.shape[1:]), fill, dtype=x.dtype,
                     device=x.device)
    buf[rows] = x
    return psum(buf, mesh, axes)


def broadcast(x: torch.Tensor, mesh: Mesh, src: int = 0) -> torch.Tensor:
    """Rank `src`'s `x` on every rank, IN PLACE (contiguous, same shape and
    dtype everywhere); returns x."""
    if mesh.size == 1:
        return x
    if not x.is_contiguous():
        raise ValueError("collectives take contiguous tensors")
    dist.broadcast(x, src, group=mesh.world)
    _count(x)
    return x


def shard_rows(n: int, mesh: Mesh, axes=WORLD) -> slice:
    """This rank's contiguous part of n rows split over `axes`: the first
    n % k ranks take one row more (torch.tensor_split's rule)."""
    k, i = mesh.axis_size(axes), mesh.axis_index(axes)
    q, r = divmod(n, k)
    lo = i * q + min(i, r)
    return slice(lo, lo + q + (1 if i < r else 0))


# ---------------------------------------------------------------------------
# local ranks
# ---------------------------------------------------------------------------


def _rank_entry(rank, fn, args, n, tmp, device, timeout_s):
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank),
                      WORLD_SIZE=str(n), LOCAL_WORLD_SIZE=str(n))
    if torch.device(device).type == "cpu":
        # the ranks share the host's cores; an explicit OMP_NUM_THREADS wins
        torch.set_num_threads(int(os.environ.get("OMP_NUM_THREADS", "0"))
                              or max(1, (os.cpu_count() or 1) // n))
    store = dist.FileStore(os.path.join(tmp, "store"), n)
    init_group(rank, n, rank, n, device, store=store, timeout_s=timeout_s)
    try:
        out = fn(*args)
        if rank == 0:
            with open(os.path.join(tmp, "result.pkl"), "wb") as f:
                pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def launch(fn, n: int, *args, device="cuda",
           timeout_s: float = DEFAULT_TIMEOUT_S,
           join_timeout_s: Optional[float] = None):
    """Run `fn(*args)` on n local ranks, each its own process in a process
    group of n (`fn` and `args` must pickle: a module-level function), and
    return rank 0's return value. A rank that raises ends the others and
    raises here; so does a group that has not finished after
    `join_timeout_s` (default: no limit beyond the group's collective
    `timeout_s`)."""
    import torch.multiprocessing as mp

    tmp = tempfile.mkdtemp(prefix="gsdf_mesh_")
    try:
        ctx = mp.start_processes(
            _rank_entry, args=(fn, args, n, tmp, str(device), timeout_s),
            nprocs=n, join=False, start_method="spawn")
        deadline = (None if join_timeout_s is None
                    else time.monotonic() + join_timeout_s)
        while not ctx.join(timeout=1.0):
            if deadline is not None and time.monotonic() > deadline:
                for p in ctx.processes:
                    if p.is_alive():
                        p.kill()
                for p in ctx.processes:
                    p.join(timeout=30)
                raise TimeoutError(f"{n} ranks did not finish within "
                                   f"{join_timeout_s} s")
        with open(os.path.join(tmp, "result.pkl"), "rb") as f:
            return pickle.load(f)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def in_group() -> bool:
    """True when this process is a rank of an initialized process group."""
    return dist.is_initialized()
