"""A dry run of both sharded layouts over gloo ranks on the CPU: the port
of `__graft_entry__.py:dryrun_multichip`.

    python -m tendrils_tpu_torch.parallel.dryrun 4

`dryrun_multichip(n_ranks)` spawns `n_ranks` processes joined in one gloo
process group through a `file://` store in a temporary directory (no TCP
port, so that runs side by side cannot collide) and runs, on each, what
`_dryrun_multichip_impl` runs: at `root_num=32` and 32x64, the
data-parallel frame (`parallel_frame`) and the slab frame
(`spatial_frame`) on both backends, two frames on "kernel" so that the
second consumes the carried force, and the `(2, D / 2)` multi-host mesh
when `n_ranks` is even and at least 4; each state finite with flow mass.
It pins each steady-state frame's collective set from `comm`'s counts:

  data-parallel, fused draw: one all-reduce (K2's int64 sums); nothing
    else;
  slab, fused draw with the carry: one reduce-scatter (both passes' 12
    channels) and one all-gather (the 2-channel decayed flow, for the
    carried force), no all-reduce.

The JAX dry run pins its slab frame at (reduce-scatter, all-gather,
all-reduce) = (6, 1, 0) from the compiled HLO (3 parts x 2 passes); the
port's is (1, 1, 0). It prints `dryrun_multichip: ok`, and raises (a
non-zero exit) on any failure.

`spawn_ranks` is the harness: a rank that raises has its traceback
re-raised in the parent, and a run past its timeout has every rank
killed, so that no rank left waiting in a collective can hang the
caller.
"""

from __future__ import annotations

import multiprocessing
import os
import queue as queue_mod
import sys
import tempfile
import time
import traceback

import torch
import torch.distributed as dist

DRYRUN = dict(root_num=32, view_res=(32, 64), flow_samples=2, flow_rows=1,
              view_samples=2)
# Each steady-state frame's collectives, by kind.
DP_SET = {"all_reduce": 1}
SLAB_SET = {"reduce_scatter": 1, "all_gather": 1}
ERROR_GRACE = 10.0  # seconds to wait for the other ranks' errors


class RankError(RuntimeError):
    """A rank of `spawn_ranks` raised; the message holds its traceback."""


def _rank_main(rank, n_ranks, store, fn, args, out):
    try:
        torch.set_num_threads(1)
        dist.init_process_group("gloo", init_method=f"file://{store}",
                                rank=rank, world_size=n_ranks)
        try:
            result = fn(rank, n_ranks, *args)
        finally:
            dist.destroy_process_group()
        out.put((rank, True, result))
    except BaseException:  # reported to the parent, which re-raises
        out.put((rank, False, traceback.format_exc()))


def spawn_ranks(fn, n_ranks, *args, timeout=300.0):
    """`[fn(rank, n_ranks, *args) for each rank]`, each in a process of
    its own (the "spawn" start method), joined in one gloo process group
    (`file://` store in a temporary directory) that `fn` runs in. `fn` and
    its results must pickle; a rank's torch uses one thread (ranks share
    the host's cores). Raises
    `RankError` with the traceback of every rank that failed (those
    reported within ERROR_GRACE seconds of the first: a rank's failure
    makes its peers' collectives fail too), or `TimeoutError` after
    `timeout` seconds; every rank is stopped either way before it
    returns."""
    ctx = multiprocessing.get_context("spawn")
    out = ctx.Queue()
    results = [None] * n_ranks
    errors = []
    with tempfile.TemporaryDirectory() as tmp:
        store = os.path.join(tmp, "store")
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(r, n_ranks, store, fn, args, out))
                 for r in range(n_ranks)]
        for p in procs:
            p.start()
        try:
            deadline = time.monotonic() + timeout
            for _ in range(n_ranks):
                try:
                    rank, ok, value = out.get(
                        timeout=max(deadline - time.monotonic(), 0.01))
                except queue_mod.Empty:
                    if errors:
                        break
                    raise TimeoutError(
                        f"{n_ranks} ranks past {timeout:.0f} s") from None
                if ok:
                    results[rank] = value
                    continue
                errors.append(f"rank {rank} of {n_ranks}:\n{value}")
                deadline = min(deadline, time.monotonic() + ERROR_GRACE)
            if errors:
                raise RankError("\n".join(errors))
            for p in procs:
                p.join(max(deadline - time.monotonic(), 1.0))
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join(5.0)
    return results


def _fresh(backend, device="cpu"):
    """A port engine at the dry run's size with a ball spawned."""
    from .. import EngineConfig, Tendrils
    from ..ops import spawn
    eng = Tendrils(EngineConfig(splat_backend=backend, gather_backend=backend,
                                **DRYRUN), device=device).setup()
    eng.spawn_shader(lambda p, e: spawn.ball(p, e._frag_xy, 0.5, 0.01))
    return eng


def _check(eng, label):
    """A finite state with flow mass on this rank (`_dryrun_multichip_impl`'s
    `check`)."""
    if not torch.isfinite(eng.sim.particles).all():
        raise AssertionError(f"{label}: non-finite particles")
    if not eng.sim.flow[3].abs().sum() > 0:
        raise AssertionError(f"{label}: the flow splat produced no mass")


def _frames(facade, count):
    """`count` frames; returns the collectives of the last, by kind."""
    from . import comm
    for _ in range(count):
        comm.reset_counts()
        facade.frame()
    return dict(comm.calls)


def _dryrun_rank(rank, n_ranks):
    from .sharding import ParallelTendrils, make_mesh, make_multihost_mesh
    from .spatial import SpatialTendrils
    mesh = make_mesh("cpu")
    for layout, facade, steady in (("dp", ParallelTendrils, DP_SET),
                                   ("slab", SpatialTendrils, SLAB_SET)):
        for backend in ("xla", "kernel"):
            eng = _fresh(backend)
            par = facade(eng, mesh)
            calls = _frames(par, 2 if backend == "kernel" else 1)
            label = f"{layout}-{backend}"
            if backend == "kernel":
                if eng.sim.force is None:
                    raise AssertionError(f"{label}: no carried force")
                if calls != steady:
                    raise AssertionError(f"{label}: steady-state "
                                         f"collectives {calls}, want {steady}")
            _check(eng, label)
    if n_ranks % 2 == 0 and n_ranks >= 4:
        eng = _fresh("xla")
        ParallelTendrils(eng, make_multihost_mesh("cpu", hosts=2)).frame()
        _check(eng, "multihost")
    return rank


def dryrun_multichip(n_ranks: int) -> None:
    """Both layouts over `n_ranks` gloo ranks on the CPU (see the module
    docstring); prints `dryrun_multichip: ok`."""
    spawn_ranks(_dryrun_rank, int(n_ranks))
    print("dryrun_multichip: ok")


if __name__ == "__main__":
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 4)
