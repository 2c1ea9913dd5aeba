"""The port's engine with the merge reorder (`EngineConfig.merge_reorder`)
at root 128 and 32x128, the smallest stream the gate admits: against the
JAX engine with the merge on, by identity (`torch_parity.compare`);
against the port's own flat-sort frame (the JAX test's bounds,
tests/test_merge_reorder_engine.py); the carry's invariants; the spawn's
fallback and recovery; `run_headless` seeding the carry; the seed's
shapes; and `convert` carrying the carry both ways.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tendrils_tpu import engine as jengine
from tendrils_tpu.ops import spawn as jspawn
from tendrils_tpu_torch import convert, engine as tengine
from tendrils_tpu_torch.ops import cuda_lib, spawn as tspawn
from tendrils_tpu_torch.ops.draw_cuda import seg_tile_count
from tendrils_tpu_torch.ops.reorder_cuda import MAXKEY
from torch_parity import compare, port_engine, sim_arrays

pytestmark = pytest.mark.kernel  # runs the JAX Pallas kernels (pytest.ini)

CFG = dict(root_num=128, view_res=(32, 128), flow_samples=2, flow_rows=1,
           view_samples=2)
FRAMES = 5
ID_BITS = 20  # gather mode 1 at this size: key = tile << 20 | id


def _port(merge):
    eng = tengine.Tendrils(tengine.EngineConfig(**CFG, merge_reorder=merge),
                           device="cpu").setup()
    eng.spawn_shader(lambda p, e: tspawn.ball(p, e._frag_xy, 0.6, 0.01))
    return eng


def _by_id(sim):
    return sim.particles[:, torch.argsort(sim.idx)].numpy()


def _check_carry(sim, cfg):
    """The carry's invariants: `sort_key` is tile-sorted and is the key
    stream of the current rows, `sort_hist` its exact tile census."""
    tiles = sim.sort_key.numpy() >> ID_BITS
    assert np.all(np.diff(tiles) >= 0)
    np.testing.assert_array_equal(sim.sort_key.numpy() & ((1 << 20) - 1),
                                  sim.idx.numpy())
    nt = seg_tile_count(cfg.view_res)
    np.testing.assert_array_equal(sim.sort_hist.numpy(),
                                  np.bincount(tiles, minlength=nt))
    np.testing.assert_array_equal(np.sort(sim.idx.numpy()),
                                  np.arange(cfg.n))


@pytest.fixture(scope="module")
def jax_run():
    """The JAX engine with the merge on, spawned, then FRAMES facade
    frames: the spawned state (numpy), its timer, and the final state."""
    cfg = jengine.EngineConfig(**CFG, splat_backend="pallas",
                               gather_backend="pallas", merge_reorder=True)
    eng = jengine.Tendrils(cfg)
    eng.setup()
    eng.spawn_shader(lambda p, e: jspawn.ball(p, e._frag_xy, 0.6, 0.01))
    start = (sim_arrays(jax.tree_util.tree_map(jnp.array, eng.sim)),
             eng.timer.time)
    for _ in range(FRAMES):
        eng.frame()
    return eng, start, sim_arrays(eng.sim)


def test_merge_frames_match_jax(jax_run):
    """FRAMES facade frames from the JAX engine's spawned state (its
    MAXKEY seed included), the merge on on both sides."""
    eng, start, want = jax_run
    assert start[0]["sort_key"] is not None
    t = port_engine(eng.config, *start)
    assert tengine.merge_reorder_enabled(t.config)
    assert (t.sim.sort_key == MAXKEY).all()
    cuda_lib.reset_counts()
    for _ in range(FRAMES):
        t.frame()
    # The seed falls back once, then every frame merges.
    assert dict(cuda_lib.events) == {"reorder_fallback": 1,
                                     "reorder_merged": FRAMES - 1}
    assert cuda_lib.plain_calls["reorder_apply"] == FRAMES
    compare(t.sim, want)
    _check_carry(t.sim, t.config)
    np.testing.assert_array_equal(
        np.sort(t.sim.sort_key.numpy()), np.sort(want["sort_key"]))
    np.testing.assert_array_equal(t.sim.sort_hist.numpy(),
                                  want["sort_hist"])


def test_merge_matches_flat_resident():
    """Merge on against merge off in the port: per identity the bounds of
    the JAX test (the U-before-C order changes the deposits' summation
    order), and the row orders differ (the merge engaged)."""
    a, b = _port(True), _port(False)
    assert tengine.merge_reorder_enabled(a.config)
    assert not tengine.merge_reorder_enabled(b.config)
    assert a.sim.sort_key is not None and b.sim.sort_key is None
    for _ in range(FRAMES):
        a.frame()
        b.frame()
    pa, pb = _by_id(a.sim), _by_id(b.sim)
    np.testing.assert_allclose(pa, pb, atol=1e-3)
    assert (np.abs(pa - pb) > 5e-5).mean() < 0.01
    np.testing.assert_allclose(a.sim.view.numpy(), b.sim.view.numpy(),
                               atol=2e-4)
    np.testing.assert_allclose(a.sim.flow.numpy(), b.sim.flow.numpy(),
                               atol=2e-4)
    assert not torch.equal(a.sim.idx, b.sim.idx)
    assert b.sim.sort_key is None
    _check_carry(a.sim, a.config)


def test_spawn_falls_back_and_recovers():
    """A mass respawn churns every key: the next frame falls back (the
    capacity guard), and the frames after it merge again."""
    a = _port(True)
    for _ in range(3):
        a.frame()
    a.spawn_shader(lambda p, e: tspawn.ball(p, e._frag_xy, 0.3, 0.02))
    cuda_lib.reset_counts()
    a.frame()
    assert dict(cuda_lib.events) == {"reorder_fallback": 1}
    _check_carry(a.sim, a.config)
    cuda_lib.reset_counts()
    for _ in range(3):
        a.frame()
    assert dict(cuda_lib.events) == {"reorder_merged": 3}
    _check_carry(a.sim, a.config)


def test_run_headless_seeds_and_strips_the_carry():
    """`run_headless` seeds the carry when the merge is enabled and
    returns a valid one; it strips the carry when the merge is off."""
    a = _port(True)
    sim = dataclasses.replace(a.sim, sort_key=None, sort_hist=None)
    cuda_lib.reset_counts()
    out = tengine.run_headless(sim, a.params(), a.config, a._view_size,
                               0.0, 1000.0 / 60.0, 4, targets_live=False)
    assert cuda_lib.events["reorder_fallback"] == 1
    assert cuda_lib.events["reorder_merged"] == 3
    _check_carry(out, a.config)
    off = dataclasses.replace(a.config, merge_reorder=False)
    out = tengine.run_headless(out, a.params(), off, a._view_size, 0.0,
                               1000.0 / 60.0, 1, targets_live=False)
    assert out.sort_key is None and out.sort_hist is None


def test_seed_shape_and_gate():
    a = _port(True)
    seeded = tengine.seed_sort_carry(a.sim, a.config)
    assert seeded.sort_key.shape == (a.config.n,)
    assert seeded.sort_key.dtype == seeded.sort_hist.dtype == torch.int32
    assert (seeded.sort_key == MAXKEY).all()
    assert seeded.sort_hist.shape == (seg_tile_count(a.config.view_res),)
    assert (seeded.sort_hist == 0).all()
    # Both gates call reorder_cuda.merge_eligible: root 64 is too small,
    # the classic frame never merges.
    for kw in (dict(root_num=64), dict(resident_stream=False)):
        cfg = dataclasses.replace(a.config, **kw)
        assert not tengine.merge_reorder_enabled(cfg)
        assert tengine.Tendrils(cfg, device="cpu").setup().sim.sort_key \
            is None


def test_draw_rejecting_the_merge_reseeds():
    """A carry on a stream the draw does not admit (n < 8192) is re-seeded
    by the resident draw, as the JAX engine does (`engine.py:516-522`)."""
    cfg = tengine.EngineConfig(**dict(CFG, root_num=64))
    eng = tengine.Tendrils(cfg, device="cpu").setup()
    eng.spawn_shader(lambda p, e: tspawn.ball(p, e._frag_xy, 0.6, 0.01))
    eng.sim = dataclasses.replace(
        eng.sim, sort_key=torch.arange(cfg.n, dtype=torch.int32),
        sort_hist=torch.ones(seg_tile_count(cfg.view_res), dtype=torch.int32))
    cuda_lib.reset_counts()
    eng.frame()
    assert not cuda_lib.events
    assert (eng.sim.sort_key == MAXKEY).all() and (eng.sim.sort_hist
                                                   == 0).all()


def test_convert_carries_the_carry(jax_run):
    """`convert` hands `sort_key` and `sort_hist` over both ways."""
    eng, _, want = jax_run
    sim = convert.sim_from_numpy(want, device="cpu")
    assert sim.sort_key.dtype == sim.sort_hist.dtype == torch.int32
    back = convert.sim_to_numpy(sim)
    for k in ("sort_key", "sort_hist", "particles", "idx"):
        np.testing.assert_array_equal(back[k], want[k], err_msg=k)
    bare = convert.sim_to_numpy(dataclasses.replace(sim, sort_key=None,
                                                    sort_hist=None))
    assert bare["sort_key"] is None and bare["sort_hist"] is None
    assert convert.sim_from_numpy(bare, device="cpu").sort_key is None
