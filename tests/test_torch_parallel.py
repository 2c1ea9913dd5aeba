"""The port's sharded frames (`tendrils_tpu_torch.parallel`) over 2 and 4
gloo ranks on the CPU, against the JAX package's over 2 and 4 of the 8
virtual CPU devices (tests/conftest.py), its Pallas kernels in interpret
mode, and against the port's own single-device frame.

One module-scoped fixture runs every rank-side check
(tests/torch_parallel_ranks.py) in one spawn of 2 ranks and one of 4
(`parallel.dryrun.spawn_ranks`: bounded by a timeout, a rank's traceback
re-raised here), while this process runs the JAX frames. Both packages
start from one state made with numpy (a permuted `idx`, some inert rows,
a live flow and view) at `root_num=32` and 32x64, as
tests/test_parallel.py sizes its frames. Particles are compared by
identity (`idx`).

Tolerances: the port against the JAX package on the "xla" backends,
JAX's own sharded-against-single tolerances (tests/test_parallel.py:76-81
for the data-parallel frame, :134-141 for the slab frame); on the kernel
backends, the port's cross-path tolerance against the JAX kernel frames
(`torch_parity.compare`: the Pallas splat sums bf16 products, which moves
a deposit by a texel fraction) with the carried force within atol 1e-4.
The port's sharded frames against its single-device frame: the same JAX
tolerances; the fused draw's summed int64 sums equal the single device's
exactly (integer adds, every rank at the single device's fixed-point
steps).
"""

import concurrent.futures
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tendrils_tpu import EngineConfig as JConfig, Tendrils as JTendrils
from tendrils_tpu.parallel import (make_mesh as jmake_mesh,
                                   parallel_frame as jparallel_frame,
                                   shard_sim as jshard_sim,
                                   shard_sim_spatial as jshard_sim_spatial,
                                   spatial_frame as jspatial_frame)
from tendrils_tpu.state import SimState as JSimState
from tendrils_tpu_torch import convert
from tendrils_tpu_torch.const import INERT
from tendrils_tpu_torch.parallel import dryrun, initialize_distributed
import torch_parallel_ranks as ranks
from torch_parity import compare, sim_arrays

pytestmark = pytest.mark.kernel  # runs the JAX Pallas kernels (pytest.ini)

CFG = dict(root_num=32, view_res=(32, 64), flow_samples=2, flow_rows=1,
           view_samples=2)
WORLDS = (2, 4)
# (layout, JAX backend, ranks) of the JAX frames the port is held to.
JAX_CASES = (("dp", "pallas", 2), ("dp", "xla", 2), ("dp", "xla", 4),
             ("slab", "pallas", 4), ("slab", "xla", 2), ("slab", "xla", 4))
# tests/test_parallel.py's tolerances: (particles rtol, atol), (grids
# rtol, atol), for the data-parallel (:76-81) and the slab frame
# (:134-141).
TOL = {"dp": ((1e-4, 1e-6), (1e-4, 1e-5)),
       "slab": ((1e-4, 5e-5), (1e-4, 1e-5))}
FORCE_TOL = (1e-4, 1e-5)
SPAWN_TIMEOUT = 240.0


def _arrays(seed, root, view_res):
    """A SimState as numpy arrays, from one seed: particles in a disc with
    small velocities (a sixteenth inert), a permuted `idx`, a live flow
    (stamps up to the frame's time) and view, a 1x1 colour map."""
    rng = np.random.default_rng(seed)
    n, (h, w) = root * root, view_res
    pos = rng.uniform(-0.7, 0.7, (2, n))
    vel = np.clip(rng.normal(0.0, 0.004, (2, n)), -0.009, 0.009)
    particles = np.concatenate([pos, vel]).astype(np.float32)
    previous = np.concatenate([pos - vel, vel]).astype(np.float32)
    inert = rng.random(n) < 1 / 16
    particles[:2, inert] = INERT
    previous[:2, inert] = INERT
    flow = np.stack([rng.normal(0.0, 0.005, (h, w)),
                     rng.normal(0.0, 0.005, (h, w)),
                     rng.uniform(0.0, 16.0, (h, w)),
                     rng.uniform(0.0, 1.0, (h, w))]).astype(np.float32)
    return dict(
        particles=particles, previous=previous,
        targets=np.zeros((4, n), np.float32), flow=flow,
        view=rng.uniform(0.0, 1.0, (1, 4, h, w)).astype(np.float32),
        color_map=np.float32([0.8, 0.5, 0.3, 1.0]).reshape(4, 1, 1),
        key=np.zeros(2, np.uint32),
        idx=rng.permutation(n).astype(np.int32))


def _jax_frames(arrays, params, view_size):
    """The JAX sharded frames of `JAX_CASES`, one frame each from
    `arrays` at time 16 ms, as numpy arrays."""
    out = {}
    for layout, backend, d in JAX_CASES:
        cfg = JConfig(splat_backend=backend, gather_backend=backend, **CFG)
        mesh = jmake_mesh(jax.devices()[:d])
        sim = JSimState(**{k: jnp.asarray(v) for k, v in arrays.items()})
        shard, frame = ((jshard_sim, jparallel_frame) if layout == "dp"
                        else (jshard_sim_spatial, jspatial_frame))
        out[layout, backend, d] = sim_arrays(frame(
            shard(sim, mesh), params, jnp.float32(ranks.TIME),
            jnp.float32(ranks.DT), cfg, view_size, mesh))
    return out


@pytest.fixture(scope="module")
def world():
    arrays = _arrays(0, CFG["root_num"], CFG["view_res"])
    jeng = JTendrils(JConfig(**CFG))
    jeng.setup()
    params = jeng.params()
    port_cfg = dataclasses.asdict(convert.engine_config(JConfig(**CFG)))
    with concurrent.futures.ThreadPoolExecutor(len(WORLDS)) as pool:
        futures = {d: pool.submit(
            dryrun.spawn_ranks, ranks.run, d, arrays,
            {k: np.asarray(v) for k, v in params.items()}, port_cfg,
            _arrays(1, 128, CFG["view_res"]), timeout=SPAWN_TIMEOUT)
            for d in WORLDS}
        frames = _jax_frames(arrays, params, jeng._view_size)
        results = {d: f.result() for d, f in futures.items()}
    return dict(jax=frames, ranks=results)


def _joined(results, name, frame=0, slab=False):
    """The ranks' shares of one frame joined: rows in rank order, the
    grids joined from the slabs, or (data-parallel) rank 0's, which must
    be every rank's bit for bit."""
    shares = [r[name][frame] for r in results]
    out = {k: (None if shares[0][k] is None
               else np.concatenate([s[k] for s in shares], axis=-1))
           for k in ranks.ROWS}
    for k, axis in (("flow", 1), ("view", 2)):
        if slab:
            out[k] = np.concatenate([s[k] for s in shares], axis=axis)
        else:
            for s in shares[1:]:
                np.testing.assert_array_equal(s[k], shares[0][k],
                                              err_msg=f"{name} {k}")
            out[k] = shares[0][k]
    return out


def _by_id(state, k):
    return state[k][:, np.argsort(state["idx"])]


def _close(got, want, tol, force=True):
    """Particles, previous and the carried force by identity, the grids
    as they are, within `tol` (`TOL[...]`)."""
    (prt, pat), (grt, gat) = tol
    np.testing.assert_array_equal(np.sort(got["idx"]),
                                  np.arange(got["idx"].size))
    for k in ("particles", "previous"):
        np.testing.assert_allclose(_by_id(got, k), _by_id(want, k), rtol=prt,
                                   atol=pat, err_msg=k)
    if force:
        assert (got["force"] is None) == (want["force"] is None)
        if want["force"] is not None:
            np.testing.assert_allclose(
                _by_id(got, "force"), _by_id(want, "force"),
                rtol=FORCE_TOL[0], atol=FORCE_TOL[1], err_msg="force")
    for k in ("flow", "view"):
        np.testing.assert_allclose(got[k], want[k], rtol=grt, atol=gat,
                                   err_msg=k)
    assert (got["flow"][3] > 1e-3).any()


def _against_jax(world, layout, backend, d):
    got = _joined(world["ranks"][d], f"{layout}_"
                  f"{'kernel' if backend == 'pallas' else 'xla'}",
                  slab=layout == "slab")
    want = world["jax"][layout, backend, d]
    if backend == "xla":
        _close(got, want, TOL[layout])
        return
    # The kernel frames: the cross-path tolerance (`compare`) on a port
    # state holding the joined arrays.
    arrays = dict(got, targets=np.zeros_like(got["particles"]),
                  color_map=np.zeros((4, 1, 1), np.float32))
    compare(convert.sim_from_numpy(arrays, device="cpu"), want)


@pytest.mark.parametrize("backend,d", [("pallas", 2), ("xla", 2),
                                       ("xla", 4)])
def test_parallel_frame_matches_jax(world, backend, d):
    """`parallel_frame` over D gloo ranks against the JAX `parallel_frame`
    over D devices: the resident frame with the carried force (K4) on the
    kernel backends, the generic draw on "xla"."""
    _against_jax(world, "dp", backend, d)


@pytest.mark.parametrize("backend,d", [("pallas", 4), ("xla", 2),
                                       ("xla", 4)])
def test_spatial_frame_matches_jax(world, backend, d):
    """`spatial_frame` over D ranks against the JAX `spatial_frame`: row
    slabs joined; on the kernel backends with the carry (the force
    gathered from the all-gathered slab flow, K7 and the un-sort)."""
    _against_jax(world, "slab", backend, d)


SINGLE = ("dp_kernel", "dp_kernel_k3", "dp_classic", "dp_xla",
          "slab_kernel", "slab_xla")


@pytest.mark.parametrize("d", WORLDS)
@pytest.mark.parametrize("name", SINGLE)
def test_sharded_matches_single_device(world, name, d):
    """The port's sharded frame against the port's single-device frame on
    the same state: the data-parallel frame (two resident frames, the
    second consuming the carried force; one with K3 resolving; two
    classic frames, the force gathered by K7 and un-sorted; one on "xla")
    against `engine._frame`, the slab frame against a step and a plain
    draw with the slab step's gather order. A shard's resident draw takes
    gather mode 3 (its ids bound by the frame's rows) where one device of
    this size takes mode 1, and mode 3 clears the positions' low mantissa
    bits: the single device's resident frames run in mode 3 too
    (`torch_parallel_ranks._Mode3`)."""
    results = world["ranks"][d]
    single = results[0]["single"][name]
    layout = name.split("_")[0]
    if layout == "slab":
        _close(_joined(results, name, slab=True), single, TOL["slab"],
               force=False)
        return
    for frame, want in enumerate(single):
        _close(_joined(results, name, frame), want, TOL["dp"])


@pytest.mark.parametrize("d", WORLDS)
def test_fused_sums_equal_single_device(world, d):
    """The data-parallel fused draw's int64 sums, summed over the ranks
    before their conversion, are the single device's bit for bit, in
    every K2 call (two resident frames in gather mode 3 on both sides; the
    frame resolved by K3; two classic frames, in mode 1 on both)."""
    results = world["ranks"][d]
    for name in ("dp_kernel", "dp_kernel_k3", "dp_classic"):
        single = results[0]["single"][name]
        for frame, want in enumerate(single):
            assert len(want["sums"]) == 1
            for r in results:
                got = r[name][frame]["sums"]
                assert len(got) == 1 and got[0].dtype == np.int64
                np.testing.assert_array_equal(got[0], want["sums"][0])


@pytest.mark.parametrize("backend", ["kernel", "xla"])
def test_multihost_mesh_matches_flat(world, backend):
    """The `(2, 2)` multi-host mesh against the flat 4-rank mesh
    (tests/test_parallel.py:193-220's tolerances)."""
    results = world["ranks"][4]
    flat = _joined(results, f"dp_{backend}")
    shares = [dict(r["multihost"][backend]) for r in results]
    mh = _joined([{"mh": [s]} for s in shares], "mh")
    np.testing.assert_allclose(mh["particles"], flat["particles"],
                               rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(mh["flow"], flat["flow"], rtol=1e-4,
                               atol=1e-6)


def test_merge_reorder_runs(world):
    """`ParallelTendrils` with `merge_reorder=True` (16,384 particles, 2
    ranks of 8,192 rows, gather mode 3 on each): 3 frames, each rank's
    merge carry its own rows, the first frame falling back from the
    re-seeded carry and a later one merging; finite state, flow mass, the
    ids still a permutation. (The JAX facade crashes here: its specs
    leave out the carry, ROADMAP queue 3.)"""
    results = [r["merge"] for r in world["ranks"][2]]
    for m in results:
        assert m["finite"] and m["flow_mass"] > 0
        assert m["rows"] == m["key_rows"] == 8192
        assert m["events"].get("reorder_fallback", 0) >= 1, m["events"]
        assert m["events"].get("reorder_merged", 0) >= 1, m["events"]
        assert m["launches"].get("reorder_apply", 0) >= 1
    ids = np.concatenate([m["ids"] for m in results])
    np.testing.assert_array_equal(np.sort(ids), np.arange(128 * 128))


STEADY = {"dp_kernel": {"all_reduce": 1},
          "slab_kernel": {"reduce_scatter": 1, "all_gather": 1}}
FIRST = {"dp_kernel": {"all_reduce": 1}, "dp_classic": {"all_reduce": 1},
         "dp_xla": {"all_reduce": 1},
         "slab_kernel": {"reduce_scatter": 1, "all_gather": 2},
         "slab_xla": {"reduce_scatter": 1, "all_gather": 1}}


@pytest.mark.parametrize("d", WORLDS)
def test_collective_sets(world, d):
    """Each frame's collectives from `comm`'s counts: the data-parallel
    fused frame one all-reduce (K2's int64 sums), the generic one one
    (both passes' f32 parts); the slab frame one reduce-scatter (both
    passes' 12 channels) and, with the carry, one all-gather (the
    2-channel decayed flow), plus the first frame's step all-gather; no
    all-reduce."""
    for r in world["ranks"][d]:
        for name, want in FIRST.items():
            assert r[name][0]["calls"] == want, name
        for name, want in STEADY.items():
            assert r[name][1]["calls"] == want, name


@pytest.mark.parametrize("d", WORLDS)
def test_slab_moves_fewer_bytes(world, d):
    """The slab layout's reason to exist (tests/test_parallel.py:400): its
    steady-state frame sends fewer bytes a rank (ring model) than the
    data-parallel frame's all-reduce of the int64 sums."""
    r = world["ranks"][d][0]
    dp = sum(r["dp_kernel"][1]["moved"].values())
    slab = sum(r["slab_kernel"][1]["moved"].values())
    assert 0 < slab < 0.7 * dp, (slab, dp)


def test_constraints_raise(world):
    """Each layout's constraints raise `ValueError` on every rank: H not
    divisible by the ranks, another flow grid shape, two view buffers, two
    flow levels, the particle count not divisible (both layouts)."""
    for r in world["ranks"][4]:
        assert set(r["constraints"]) == {
            "slab H", "slab flow_res", "slab buffers", "slab levels",
            "slab n", "dp n"}, r["constraints"]


@pytest.mark.parametrize("d", WORLDS)
def test_comm_round_trip(world, d):
    """`comm`'s layouts: the reduce-scatter keeps this rank's slab of the
    sum, the all-gather joins the slabs in rank order, the int64
    all-reduce is exact, the broadcast rank 0's."""
    for r in world["ranks"][d]:
        assert r["comm"] == dict(slab=True, whole=True, i64=True,
                                 broadcast=True)


def test_dryrun_multichip(capsys):
    """`python -m tendrils_tpu_torch.parallel.dryrun 4`'s function."""
    dryrun.dryrun_multichip(4)
    assert capsys.readouterr().out.strip().endswith("dryrun_multichip: ok")


def test_spawned_rank_errors_reach_the_caller():
    """A rank that raises has its traceback raised here, and no rank left
    waiting in a collective outlives the call."""
    with pytest.raises(dryrun.RankError, match="rank 1 fails"):
        dryrun.spawn_ranks(ranks.fail_on_rank_1, 2, timeout=60.0)


def test_initialize_distributed_needs_a_launcher(monkeypatch):
    """Without a launcher's environment or an `init_method`,
    `initialize_distributed` does nothing."""
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR"):
        monkeypatch.delenv(k, raising=False)
    initialize_distributed("cpu")
    assert not torch.distributed.is_initialized()
