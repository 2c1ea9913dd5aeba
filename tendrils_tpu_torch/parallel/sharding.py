"""Data-parallel particle sharding over ranks: the port of
`tendrils_tpu/parallel/sharding.py` on `torch.distributed`.

Layout (one process a rank, rank r of D holding rows r N / D to (r + 1) N
/ D):
  particles / previous / targets / idx / the merge-reorder keys: this
  rank's contiguous block of rows;
  flow / view / color_map: whole on every rank (replicated).

The step needs no collective (each particle reads only the replicated
grids). The draw makes one: the fused draw sums K2's int64 fixed-point
sums over the ranks before their conversion (`draw_cuda.fused_draw(
psum=...)`), every rank at the steps of the whole frame's rows, so the
accumulator, and every grid resolved from it, is the single device's bit
for bit; the generic draw sums its f32 parts (`engine._draw_generic`).
Every rank then resolves the whole grids (K3 or the XLA tail), and the
next force is gathered per rank from the replicated flow at its own rows
(K4 on the resident stream, K7 and the un-sort on the classic one), so the
carried force costs no collective; K5 gathers it on the first frame.

A mesh is a `torch.distributed.device_mesh.DeviceMesh` over every rank of
the process group, in rank order: 1-D `("dp",)` (`make_mesh`) or 2-D
`("host", "dp")` (`make_multihost_mesh`). The particles shard over its
dimensions flattened and the sums reduce over the whole group, whose NCCL
backend stages the reduction within and across hosts itself. Call
`initialize_distributed()` first in a launch by `torchrun`.
"""

from __future__ import annotations

import dataclasses
import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..engine import EngineConfig, _frame
from ..ops.reorder_cuda import MAXKEY
from . import comm

AXIS = "dp"
HOST_AXIS = "host"
# The SimState fields a rank keeps a block of: rows at the last dimension.
ROW_FIELDS = ("particles", "previous", "targets", "idx")
GRID_FIELDS = ("flow", "view", "color_map")


def initialize_distributed(device="cuda", **kw):
    """A guarded `dist.init_process_group` for launches of several
    processes (`torchrun --nproc-per-node N`): nothing when the group is
    already initialised, or when neither the launcher's environment
    (`RANK`, `WORLD_SIZE`, `MASTER_ADDR`) nor an `init_method` is given.
    `device="cuda"` takes NCCL, on the card `LOCAL_RANK` names; "cpu"
    gloo. `kw` goes to `init_process_group`. Safe to call
    unconditionally at program start."""
    if dist.is_initialized():
        return
    if "init_method" not in kw and not all(
            k in os.environ for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR")):
        return
    backend = "gloo"
    if torch.device(device).type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        backend = "nccl"
    dist.init_process_group(kw.pop("backend", backend), **kw)


def make_mesh(device_type="cuda", axis=AXIS) -> DeviceMesh:
    """The 1-D mesh over every rank of the process group."""
    return DeviceMesh(device_type, torch.arange(dist.get_world_size()),
                      mesh_dim_names=(axis,))


def make_multihost_mesh(device_type="cuda", hosts=None) -> DeviceMesh:
    """The `(hosts, chips)` mesh over every rank, host-major, so each
    host's ranks are mesh-contiguous. `hosts` defaults to the world size
    over `torchrun`'s `LOCAL_WORLD_SIZE` (1 without it); on one host, pass
    it to check the composition on local ranks."""
    world = dist.get_world_size()
    if hosts is None:
        hosts = world // int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if world % hosts:
        raise ValueError(f"{world} ranks not divisible by {hosts} hosts")
    return DeviceMesh(device_type, torch.arange(world).reshape(hosts, -1),
                      mesh_dim_names=(HOST_AXIS, AXIS))


def mesh_group(mesh: DeviceMesh):
    """The group a mesh's particles shard over and its sums reduce over:
    every rank in rank order, the mesh's own group when it is 1-D, else
    the whole world's (its dimensions flattened)."""
    if mesh.mesh.flatten().tolist() != list(range(dist.get_world_size())):
        raise ValueError("a mesh spans every rank of the process group, in "
                         "rank order")
    return mesh.get_group(0) if mesh.ndim == 1 else dist.group.WORLD


def row_block(n, group):
    """`(lo, hi)`: this rank's contiguous block of `n` rows."""
    d, r = dist.get_world_size(group), dist.get_rank(group)
    if n % d:
        raise ValueError(f"particle count {n} not divisible by {d} ranks")
    return r * n // d, (r + 1) * n // d


def broadcast_state(sim, group, fields):
    """`sim` with rank 0's copy of each tensor field of `fields`, so the
    ranks do not depend on each making the same state (a fresh copy on
    every rank: the caller's tensors stay as they were)."""
    return dataclasses.replace(sim, **{
        f: comm.broadcast(getattr(sim, f).clone().contiguous(), group)
        for f in fields})


def shard_sim(sim, mesh: DeviceMesh):
    """This rank's share of a SimState: rank 0's state (broadcast), cut to
    this rank's block of rows, the grids whole. The carried force is
    dropped (the first sharded frame gathers it, K5, then carries it per
    rank), and the merge-reorder carry, where the state has one, is
    re-seeded for the block (MAXKEY keys, an empty census): a block of the
    single device's carry would pair this rank's keys with the census of
    every row, and a shard's keys may take another gather mode. The first
    frame flat-sorts and each rank's carry then covers its own rows."""
    group = mesh_group(mesh)
    sim = broadcast_state(dataclasses.replace(sim, force=None), group,
                          ROW_FIELDS + GRID_FIELDS)
    lo, hi = row_block(sim.particles.shape[1], group)
    kw = {f: getattr(sim, f)[..., lo:hi].contiguous() for f in ROW_FIELDS}
    if sim.sort_key is not None:
        kw["sort_key"] = torch.full((hi - lo,), MAXKEY, dtype=torch.int32,
                                    device=sim.particles.device)
        kw["sort_hist"] = torch.zeros_like(sim.sort_hist)
    return dataclasses.replace(sim, **kw)


def parallel_frame(sim, params, time, dt, cfg: EngineConfig, view_size,
                   mesh: DeviceMesh, targets_live=True, fast_resolve=False,
                   host_widths=None):
    """One step + draw frame on this rank's shard (`shard_sim`), the
    single device's frame (`engine._frame`) with the draw reduced over the
    mesh's ranks: the same variant the single device picks (resident,
    carried force, the fused resolve with `fast_resolve`). The resident
    draw bounds the ids by `cfg.n`, as they stay global (a shard of config
    2 takes gather mode 3 where one device takes mode 1). With the carried
    force the returned shard carries this rank's force for the next frame,
    gathered from the replicated flow. `host_widths` as `engine._frame`'s.
    """
    return _frame(sim, params, time, dt, cfg, view_size,
                  targets_live=targets_live, fast_resolve=fast_resolve,
                  host_widths=host_widths, axis_name=mesh_group(mesh))


class ParallelTendrils:
    """Engine facade over ranks: the `Tendrils` engine's state sharded
    (`shard_sim`) and its frame run through `parallel_frame`. Every rank
    builds its engine and calls `frame()` in step."""

    def __init__(self, engine, mesh: DeviceMesh | None = None):
        from ..engine import Tendrils
        if not isinstance(engine, Tendrils):
            raise TypeError("ParallelTendrils wraps a Tendrils engine")
        self.engine = engine
        self.mesh = mesh if mesh is not None \
            else make_mesh(engine.device.type)
        d, n = self.mesh.size(), engine.config.n
        if n % d:
            raise ValueError(
                f"particle count {n} not divisible by {d} ranks")
        engine.sim = shard_sim(engine.sim, self.mesh)

    def frame(self):
        """tick + the sharded frame (no `flow_off`, as the JAX facade)."""
        eng = self.engine
        eng.timer.tick()
        eng._check_force_params()
        if eng.timer.paused:
            return self
        x = eng._frame_inputs()
        eng.sim = parallel_frame(
            eng.sim, x.params, x.time, x.dt, eng.config, eng._view_size,
            self.mesh, targets_live=x.targets_live,
            fast_resolve=x.fast_resolve, host_widths=x.host_widths)
        return self
