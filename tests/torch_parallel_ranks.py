"""The rank side of tests/test_torch_parallel.py: what each gloo rank runs
(`parallel.dryrun.spawn_ranks`), on the CPU, from one state handed over as
numpy arrays. Imports no JAX: the spawned processes import this module.

`run(rank, n_ranks, arrays, params, cfg_kw, merge_arrays)` runs every
check of a world of `n_ranks` ranks and returns numpy results: each
sharded frame's local rows and grids, the comm counts of each frame, and
on rank 0 the single-device frames of the same state (the port's own
reference, `engine._frame` and `step_sim` + `draw_sim`) with the int64
sums each K2 call converted (`draw_cuda.splat_convert`'s input).
"""

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from tendrils_tpu_torch import convert, engine
from tendrils_tpu_torch.ops import coords, cuda_lib, draw_cuda
from tendrils_tpu_torch.parallel import (ParallelTendrils, SpatialTendrils,
                                         comm, make_mesh, make_multihost_mesh,
                                         parallel_frame, shard_sim,
                                         shard_sim_spatial, spatial_frame)

TIME, DT = 16.0, 16.0
ROWS = ("particles", "previous", "idx", "force")
KERNEL = dict(splat_backend="kernel", gather_backend="kernel")
XLA = dict(splat_backend="xla", gather_backend="xla")


def _np(t):
    return None if t is None else t.detach().cpu().numpy()


class _Sums:
    """Records the int64 sums each K2 call converts (`splat_convert`'s
    input: after the sum over the ranks on a shard)."""

    def __init__(self):
        self.got = []
        self._orig = draw_cuda.splat_convert

    def __enter__(self):
        def record(scal, sums, **kw):
            self.got.append(sums.clone().numpy())
            return self._orig(scal, sums, **kw)
        draw_cuda.splat_convert = record
        return self

    def __exit__(self, *exc):
        draw_cuda.splat_convert = self._orig


class _Mode3:
    """The single device's resident draw in the gather mode of the shards
    (3: the ids' bound is the frame's rows, beyond a shard's), whose id
    channel clears the riding positions' low mantissa bits (x: 2, y: 3)
    before they are quantised: the single device sees the same positions
    as the shards, and its frame is theirs."""

    def __init__(self):
        self._orig = draw_cuda.gather_mode

    def __enter__(self):
        def mode3(n, num_tiles, *, ids, resident, idx_bound=None):
            return self._orig(n, num_tiles, ids=ids, resident=resident,
                              idx_bound=None if idx_bound is None
                              else 2 * n)
        draw_cuda.gather_mode = mode3
        return self

    def __exit__(self, *exc):
        draw_cuda.gather_mode = self._orig


def _inputs(arrays, params, cfg_kw, **over):
    cfg = engine.EngineConfig(**dict(cfg_kw, **over))
    h, w = cfg.view_res
    return (cfg, convert.sim_from_numpy(arrays, device="cpu"),
            convert.params_from_numpy(params, device="cpu"),
            torch.as_tensor(coords.cover_aspect((w, h))))


def _state(sim, rows=ROWS, grids=("flow", "view")):
    return {k: _np(getattr(sim, k)) for k in rows + grids}


def _times(frames):
    return [(torch.tensor(TIME * (i + 1)), torch.tensor(DT))
            for i in range(frames)]


def _dp(mesh, arrays, params, cfg_kw, frames, fast_resolve, **over):
    """`parallel_frame` for `frames` frames: per frame this rank's state,
    the converted sums and the comm counts."""
    cfg, sim, p, vs = _inputs(arrays, params, cfg_kw, **over)
    sim = shard_sim(sim, mesh)
    out = []
    for t, dt in _times(frames):
        comm.reset_counts()
        with _Sums() as sums:
            sim = parallel_frame(sim, p, t, dt, cfg, vs, mesh,
                                 fast_resolve=fast_resolve,
                                 host_widths=engine.host_widths(p))
        out.append(dict(_state(sim), sums=sums.got,
                        calls=dict(comm.calls), moved=dict(comm.moved)))
    return out


def _dp_single(arrays, params, cfg_kw, frames, fast_resolve, **over):
    """The single device's `engine._frame` on the whole state; its
    resident frame in the shards' gather mode (`_Mode3`)."""
    cfg, sim, p, vs = _inputs(arrays, params, cfg_kw, **over)
    out = []
    for t, dt in _times(frames):
        with _Sums() as sums, _Mode3():
            sim = engine._frame(sim, p, t, dt, cfg, vs,
                                fast_resolve=fast_resolve,
                                host_widths=engine.host_widths(p))
        out.append(dict(_state(sim), sums=sums.got))
    return out


def _slab(mesh, arrays, params, cfg_kw, frames, **over):
    cfg, sim, p, vs = _inputs(arrays, params, cfg_kw, **over)
    sim = shard_sim_spatial(sim, mesh)
    out = []
    for t, dt in _times(frames):
        comm.reset_counts()
        sim = spatial_frame(sim, p, t, dt, cfg, vs, mesh,
                            host_widths=engine.host_widths(p))
        out.append(dict(_state(sim), calls=dict(comm.calls),
                        moved=dict(comm.moved)))
    return out


def _slab_single(arrays, params, cfg_kw, **over):
    """One step + plain draw with the slab step's gather order (decay,
    then interpolate: the "kernel" gather), as tests/test_parallel.py
    compares the JAX slab frame."""
    cfg, sim, p, vs = _inputs(arrays, params, cfg_kw, **over)
    cfg = dataclasses.replace(cfg, gather_backend="kernel")
    t, dt = _times(1)[0]
    sim = engine.step_sim(sim, p, t, dt, cfg, vs)
    sim = engine.draw_sim(sim, p, t, cfg, vs,
                          host_widths=engine.host_widths(p))
    return _state(sim)


def _comm_round_trip(rank, n_ranks):
    """The comm layouts on small tensors: the reduce-scatter keeps this
    rank's slab of the sum, the all-gather joins the slabs in rank order,
    the all-reduce sums int64 exactly, the broadcast is rank 0's."""
    def x(r):
        g = torch.Generator().manual_seed(r)
        return torch.randn((3, 8, 5), generator=g)
    total = sum(x(r) for r in range(n_ranks))
    h = 8 // n_ranks
    slab = comm.reduce_scatter_rows(x(rank))
    whole = comm.all_gather_rows(slab)
    i64 = comm.all_reduce_sum(torch.full((4,), 2 ** 40 + rank,
                                         dtype=torch.int64))
    b = comm.broadcast(torch.full((2,), float(rank)))
    return dict(
        slab=torch.allclose(slab, total[:, rank * h:(rank + 1) * h],
                            rtol=1e-6, atol=1e-6),
        whole=torch.allclose(whole, total, rtol=1e-6, atol=1e-6),
        i64=bool((i64 == n_ranks * 2 ** 40
                  + n_ranks * (n_ranks - 1) // 2).all()),
        broadcast=bool((b == 0).all()))


def _merge(mesh, merge_arrays, cfg_kw, frames=3):
    """`ParallelTendrils` with the merge reorder on a resident config: each
    rank's merge carry covers its own rows (the JAX facade's specs leave
    the carry out, ROADMAP queue 3)."""
    cfg = engine.EngineConfig(**dict(cfg_kw, root_num=128,
                                     merge_reorder=True, **KERNEL))
    eng = engine.Tendrils(cfg, device="cpu").setup()
    eng.sim = convert.sim_from_numpy(merge_arrays, device="cpu")
    eng.reseed_derived()
    par = ParallelTendrils(eng, mesh)
    cuda_lib.reset_counts()
    for _ in range(frames):
        par.frame()
    sim = eng.sim
    return dict(finite=bool(torch.isfinite(sim.particles).all()),
                flow_mass=float(sim.flow[3].abs().sum()),
                rows=sim.particles.shape[1], key_rows=sim.sort_key.shape[0],
                events=dict(cuda_lib.events),
                launches=dict(cuda_lib.plain_calls),
                ids=_np(sim.idx))


def _constraints(mesh, cfg_kw):
    """The layouts' constraints, each a `ValueError` raised on every rank
    before any collective."""
    errs = {}
    cases = {
        "slab H": (SpatialTendrils, dict(view_res=(30, 64))),
        "slab flow_res": (SpatialTendrils, dict(flow_res=(16, 32))),
        "slab buffers": (SpatialTendrils, dict(num_view_buffers=2)),
        "slab levels": (SpatialTendrils, dict(flow_levels=2)),
        "slab n": (SpatialTendrils, dict(root_num=31)),
        "dp n": (ParallelTendrils, dict(root_num=31)),
    }
    for name, (facade, over) in cases.items():
        eng = engine.Tendrils(engine.EngineConfig(**dict(cfg_kw, **over)),
                              device="cpu").setup()
        try:
            facade(eng, mesh)
        except ValueError as e:
            errs[name] = str(e)
    return errs


def run(rank, n_ranks, arrays, params, cfg_kw, merge_arrays):
    mesh = make_mesh("cpu")
    res = {"comm": _comm_round_trip(rank, n_ranks)}
    kernel, xla = KERNEL, XLA
    res["dp_kernel"] = _dp(mesh, arrays, params, cfg_kw, 2, False, **kernel)
    res["dp_kernel_k3"] = _dp(mesh, arrays, params, cfg_kw, 1, True,
                              **kernel)
    res["dp_classic"] = _dp(mesh, arrays, params, cfg_kw, 2, False,
                            resident_stream=False, **kernel)
    res["dp_xla"] = _dp(mesh, arrays, params, cfg_kw, 1, False, **xla)
    res["slab_kernel"] = _slab(mesh, arrays, params, cfg_kw, 2, **kernel)
    res["slab_xla"] = _slab(mesh, arrays, params, cfg_kw, 1, **xla)
    res["constraints"] = _constraints(mesh, cfg_kw)
    if n_ranks == 2:
        res["merge"] = _merge(mesh, merge_arrays, cfg_kw)
    if n_ranks == 4:
        mh = make_multihost_mesh("cpu", hosts=2)
        res["multihost"] = {
            b: _dp(mh, arrays, params, cfg_kw, 1, False, **over)[0]
            for b, over in (("kernel", kernel), ("xla", xla))}
    if rank == 0:
        res["single"] = {
            "dp_kernel": _dp_single(arrays, params, cfg_kw, 2, False,
                                    **kernel),
            "dp_kernel_k3": _dp_single(arrays, params, cfg_kw, 1, True,
                                       **kernel),
            "dp_classic": _dp_single(arrays, params, cfg_kw, 2, False,
                                     resident_stream=False, **kernel),
            "dp_xla": _dp_single(arrays, params, cfg_kw, 1, False, **xla),
            "slab_kernel": _slab_single(arrays, params, cfg_kw, **kernel),
            "slab_xla": _slab_single(arrays, params, cfg_kw, **xla)}
    res["rank"] = dist.get_rank()
    return res


def fail_on_rank_1(rank, n_ranks):
    """Rank 1 raises while rank 0 waits in a collective."""
    if rank == 1:
        raise RuntimeError("rank 1 fails")
    comm.all_reduce_sum(torch.zeros(1))
    return rank
