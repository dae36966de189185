"""Process groups and collectives for rendering over several devices
(counterpart of core_tpu/parallel/distributed.py).

One process per device, SPMD: every rank runs the same program, joins one
torch.distributed group, and parallel/sharding.py splits the film's rows
(and optionally the samples) over a ("tiles", "spp") mesh of the ranks.

Env-driven, so launchers stay simple (core_tpu's names first, then
torchrun's):
  CORE_TPU_COORDINATOR   host:port of rank 0   (or MASTER_ADDR:MASTER_PORT)
  CORE_TPU_NUM_PROCESSES the number of ranks   (or WORLD_SIZE)
  CORE_TPU_PROCESS_ID    this process's rank   (or RANK)
A rank renders on cuda:LOCAL_RANK (LOCAL_RANK from the env, else its rank
modulo the card count) unless the caller names a device.  The backend is
NCCL for CUDA devices and gloo for the CPU; a caller may name gloo for CUDA
tensors (several ranks on one card, which NCCL refuses).

The collectives (all_reduce, all_gather, halo_exchange) count their calls
and bytes in STATS, and with TIMING on their seconds (synchronising the
card around each call).  Gloo takes CUDA tensors for only some
collectives, so on a gloo group every CUDA tensor goes through host memory:
chosen by the group's backend, never in reaction to a failure.
"""
from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import Any

import torch
import torch.distributed as dist

# this rank's device, set by init_distributed (torch.distributed's own
# state is per process too)
_device: torch.device | None = None
_meshes: dict = {}

# collective name -> [calls, bytes sent by this rank, seconds]
STATS: dict = {}
TIMING = False


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None,
                     backend: str | None = None, device=None) -> bool:
    """Join (or create) the process group.  Arguments override the env.
    Returns True once a group is initialised, False for a single process
    with nothing configured (core_tpu's contract).  Idempotent.

    device: this rank's device ("cpu", "cuda" = cuda:LOCAL_RANK, or a
    named one such as "cuda:0"); backend: "nccl" or "gloo" (default by the
    device)."""
    global _device
    if dist.is_initialized():
        return True
    env = os.environ
    if coordinator_address is None:
        coordinator_address = env.get("CORE_TPU_COORDINATOR")
        if coordinator_address is None and "MASTER_ADDR" in env:
            coordinator_address = (f"{env['MASTER_ADDR']}:"
                                   f"{env.get('MASTER_PORT', '29500')}")
    if num_processes is None:
        v = env.get("CORE_TPU_NUM_PROCESSES", env.get("WORLD_SIZE"))
        num_processes = None if v is None else int(v)
    if process_id is None:
        v = env.get("CORE_TPU_PROCESS_ID", env.get("RANK"))
        process_id = None if v is None else int(v)
    if coordinator_address is None and num_processes is None:
        return False
    missing = [name for name, v in (
        ("CORE_TPU_COORDINATOR", coordinator_address),
        ("CORE_TPU_NUM_PROCESSES", num_processes),
        ("CORE_TPU_PROCESS_ID", process_id)) if v is None]
    if missing:
        raise ValueError(f"init_distributed: {', '.join(missing)} not given "
                         "(arguments or env)")
    dev = _rank_device("cuda" if device is None else device, process_id)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"no CUDA device for rank {process_id} on "
                               f"{dev}: pass device='cpu' for CPU ranks")
        torch.cuda.set_device(dev)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id)
    _device = dev
    return True


def _rank_device(device, rank: int) -> torch.device:
    device = torch.device(device)
    if device.type != "cuda" or device.index is not None:
        return device
    local = os.environ.get("LOCAL_RANK")
    if local is None:
        local = rank % max(torch.cuda.device_count(), 1)
    return torch.device("cuda", int(local))


def shutdown():
    """Leave the process group (the counterpart of
    jax.distributed.shutdown)."""
    global _device
    if dist.is_initialized():
        dist.destroy_process_group()
    _meshes.clear()
    _device = None


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank_device() -> torch.device:
    """The device this rank renders on."""
    _require_group("rank_device")
    return _device


def _require_group(what: str):
    if not dist.is_initialized():
        raise RuntimeError(
            f"{what} needs a process group: call "
            "parallel.distributed.init_distributed() in every rank first "
            "(the CLI's --devices N starts N ranks; --multihost joins from "
            "the CORE_TPU_* env)")


@dataclass(frozen=True)
class Mesh:
    """This rank's place in a ("tiles", "spp") mesh of all ranks: rank r
    is tile r // n_spp, spp shard r % n_spp (core_tpu's process-major
    device order reshaped to [n_tiles, n_spp])."""
    shape: dict             # {"tiles": n_tiles, "spp": n_spp}
    tile: int
    spp_index: int
    tiles: Any              # group of this spp shard's ranks, by tile
    spp: Any                # group of this tile's ranks, by spp shard
    world: Any
    device: torch.device


def global_mesh(spp_parallel: int = 1) -> Mesh:
    """("tiles", "spp") mesh over every rank of the group.  Every rank
    must call it (it creates the sub-groups)."""
    _require_group("global_mesh")
    n = dist.get_world_size()
    if n % spp_parallel != 0:
        raise ValueError(f"{n} ranks not divisible by "
                         f"spp_parallel={spp_parallel}")
    if spp_parallel not in _meshes:
        n_tiles = n // spp_parallel
        rank = dist.get_rank()
        # every rank creates every group, in the same order
        tiles = [dist.new_group([t * spp_parallel + s
                                 for t in range(n_tiles)])
                 for s in range(spp_parallel)]
        spps = [dist.new_group([t * spp_parallel + s
                                for s in range(spp_parallel)])
                for t in range(n_tiles)]
        tile, si = divmod(rank, spp_parallel)
        _meshes[spp_parallel] = Mesh(
            shape={"tiles": n_tiles, "spp": spp_parallel}, tile=tile,
            spp_index=si, tiles=tiles[si], spp=spps[tile],
            world=dist.group.WORLD, device=_device)
    return _meshes[spp_parallel]


# --------------------------------------------------------------------------
# collectives
# --------------------------------------------------------------------------

def reset_stats():
    STATS.clear()


def _staged(t: torch.Tensor, group) -> bool:
    return t.is_cuda and dist.get_backend(group) == "gloo"


class _Record:
    """Counts one collective call and the bytes of the tensor this rank
    sends, timed when TIMING is on."""

    def __init__(self, name: str, t: torch.Tensor):
        self.name, self.t = name, t

    def __enter__(self):
        if TIMING and self.t.is_cuda:
            torch.cuda.synchronize(self.t.device)
        self.t0 = time.perf_counter()

    def __exit__(self, *exc):
        if TIMING and self.t.is_cuda:
            torch.cuda.synchronize(self.t.device)
        rec = STATS.setdefault(self.name, [0, 0, 0.0])
        rec[0] += 1
        rec[1] += self.t.numel() * self.t.element_size()
        rec[2] += time.perf_counter() - self.t0


def all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of t over the group's ranks (a new tensor)."""
    with _Record("all_reduce", t):
        x = t.detach().to("cpu" if _staged(t, group) else t.device,
                          copy=True).contiguous()
        dist.all_reduce(x, group=group)
        return x.to(t.device)


def all_gather(t: torch.Tensor, group) -> torch.Tensor:
    """[n, *t.shape]: every rank's t, in group-rank order."""
    with _Record("all_gather", t):
        x = t.detach().to("cpu" if _staged(t, group) else t.device) \
            .contiguous()
        outs = [torch.empty_like(x)
                for _ in range(dist.get_world_size(group))]
        dist.all_gather(outs, x, group=group)
        return torch.stack(outs).to(t.device)


def _exchange(top, bottom, mesh: Mesh):
    """(the next tile's top, the previous tile's bottom), zeros at the
    ends of the tiles ring; one all_gather of the edge rows."""
    edges = all_gather(torch.stack([top, bottom]), mesh.tiles)
    ti, n = mesh.tile, mesh.shape["tiles"]
    zero = torch.zeros_like(top)
    return (edges[ti + 1, 0] if ti + 1 < n else zero,
            edges[ti - 1, 1] if ti > 0 else zero)


class _AllReduceSum(torch.autograd.Function):
    """Sum over a group; the backward sums the cotangents over the group
    (all-reduce is its own transpose)."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return all_reduce(t, group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


class _HaloExchange(torch.autograd.Function):
    """top goes to the previous tile, bottom to the next; the backward
    sends each received cotangent back the way its rows came."""

    @staticmethod
    def forward(ctx, top, bottom, mesh):
        ctx.mesh = mesh
        return _exchange(top, bottom, mesh)

    @staticmethod
    def backward(ctx, g_next, g_prev):
        g_bottom, g_top = _exchange(g_prev.contiguous(),
                                    g_next.contiguous(), ctx.mesh)
        return g_top, g_bottom, None


def sum_over(t: torch.Tensor, group) -> torch.Tensor:
    """all_reduce that autograd differentiates."""
    return _AllReduceSum.apply(t, group)


def halo_exchange(top: torch.Tensor, bottom: torch.Tensor, mesh: Mesh):
    """Along the tiles ring: (rows from the next tile's top, rows from the
    previous tile's bottom), zeros where there is none; differentiable."""
    return _HaloExchange.apply(top, bottom, mesh)
