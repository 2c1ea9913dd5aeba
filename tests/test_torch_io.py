"""The port's image export and checkpoints (`tendrils_tpu_torch/io/`)
against the JAX package's: the same PNG and PPM bytes for the same image,
the port's checkpoint round trip (the sequence of tests/test_io.py), the
npz layout both packages write, and checkpoints carried across: a JAX
checkpoint loaded into the port, field for field, then one frame on each
side from it; a port checkpoint loaded into the JAX package.

Tolerance: none for the exported bytes and the loaded fields (equal
bytes, `array_equal`). The frame after a JAX checkpoint is held as the
engine frames are (`torch_parity.compare`): particles by identity within
atol 1e-4, grids by the reference's cross-path bound. A resumed port run
against the run that saved it: equal once both gather their force in the
step, else within the engine frames' atol 1e-4 (the checkpoint drops the
carried force; see `test_checkpoint_roundtrip`).
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tendrils_tpu import engine as jengine, io as jio
from tendrils_tpu.ops import spawn as jspawn
from tendrils_tpu_torch import convert, engine as tengine, io as tio
from tendrils_tpu_torch.spawners import spawn_ball
from torch_parity import compare, sim_arrays

SIM_FIELDS = ("particles", "previous", "targets", "flow", "view",
              "color_map", "idx")


@pytest.mark.parametrize("shape", [(16, 24, 3), (7, 5, 4), (1, 1, 3)])
def test_export_bytes_match_jax(tmp_path, shape):
    """`view_to_u8` on a seeded float image, then PNG (RGB and RGBA) and
    PPM files of the same u8 image: equal arrays and equal bytes."""
    rng = np.random.default_rng(sum(shape))
    view = rng.uniform(-0.2, 1.2, (*shape[:2], 4)).astype(np.float32)
    u8 = tio.view_to_u8(view, background=(0.1, 0.2, 0.3))
    np.testing.assert_array_equal(
        u8, jio.view_to_u8(view, background=(0.1, 0.2, 0.3)))
    img = rng.integers(0, 255, shape, dtype=np.uint8)
    for kind in ("png", "ppm"):
        if kind == "ppm" and shape[2] != 3:
            continue
        paths = [str(tmp_path / f"{who}.{kind}") for who in ("jax", "port")]
        getattr(jio, f"save_{kind}")(paths[0], img)
        getattr(tio, f"save_{kind}")(paths[1], img)
        with open(paths[0], "rb") as a, open(paths[1], "rb") as b:
            assert a.read() == b.read()
    from PIL import Image
    back = np.asarray(Image.open(str(tmp_path / "port.png")))
    np.testing.assert_array_equal(back, img)


def _port_engine(root, view_res, seed=0):
    eng = tengine.Tendrils(tengine.EngineConfig(
        root_num=root, view_res=view_res, flow_samples=2, flow_rows=1,
        view_samples=2), seed=seed, device="cpu")
    return eng.setup()


def test_checkpoint_roundtrip(tmp_path):
    """tests/test_io.py's sequence on the port: 3 frames, a param edit, a
    save; a load into an engine of other shapes (rebuilt), which must give
    the particles and the timer back; then one frame on each, equal."""
    eng = _port_engine(16, (24, 32))
    spawn_ball(0.5, 0.01).spawn(eng)
    for _ in range(3):
        eng.frame()
    eng.state["noiseScale"] = 7.5
    path = tio.save_checkpoint(str(tmp_path / "ck.npz"), eng)

    p_ref = eng.sim.particles.clone()
    t_ref = eng.timer.time

    eng2 = _port_engine(8, (16, 16))
    tio.load_checkpoint(path, eng2)
    assert torch.equal(eng2.sim.particles, p_ref)
    assert eng2.timer.time == t_ref
    assert eng2.state["noiseScale"] == 7.5
    assert eng2.config.root_num == 16 and eng2.config.view_res == (24, 32)
    assert eng2.sim.force is None and eng2.sim.idx.dtype == torch.int32

    # The checkpoint leaves out the carried force (a derived cache, as in
    # the JAX package): the resumed engine gathers its first force in the
    # step (K5) at the float positions, where the saving engine carries
    # the one K4 gathered at the packed fixed-point positions, so the two
    # runs agree by identity within the engine frames' atol 1e-4 (5e-6
    # read here). With the carried force dropped, the saving engine also
    # gathers in the step and the two runs are equal.
    twin = dataclasses.replace(eng.sim, force=None)
    eng.frame()
    eng2.frame()
    assert torch.equal(eng2.sim.idx, eng.sim.idx)
    np.testing.assert_allclose(eng2.sim.particles.numpy(),
                               eng.sim.particles.numpy(), rtol=0, atol=1e-4)
    eng.sim = twin
    eng.timer.time = t_ref
    eng2.sim = dataclasses.replace(twin)
    eng2.timer.time = t_ref
    for _ in range(2):
        eng.frame()
        eng2.frame()
    for name in ("particles", "previous", "flow", "view", "force", "idx"):
        assert torch.equal(getattr(eng2.sim, name), getattr(eng.sim, name))


@pytest.fixture(scope="module")
def jax_checkpoint(tmp_path_factory):
    """A checkpoint written by the JAX package: its engine on the pallas
    backend (interpret mode) after a ball spawn and 3 frames, a param
    edit, at seed 3."""
    eng = jengine.Tendrils(jengine.EngineConfig(
        root_num=16, view_res=(32, 128), flow_samples=2, flow_rows=1,
        view_samples=2, splat_backend="pallas", gather_backend="pallas"),
        seed=3)
    eng.setup()
    eng.spawn_shader(lambda p, e: jspawn.ball(p, e._frag_xy, 0.6, 0.01))
    for _ in range(3):
        eng.frame()
    eng.state["noiseScale"] = 2.5
    path = str(tmp_path_factory.mktemp("ck") / "jax.ckpt.npz")
    jio.save_checkpoint(path, eng)
    return path, eng.config


@pytest.mark.kernel  # the frames run the JAX Pallas kernels (pytest.ini)
def test_jax_checkpoint_loads_into_the_port(jax_checkpoint):
    """The port loads the JAX checkpoint field for field (`array_equal`,
    `idx` int32, the key ignored), with the same state and timer; then one
    frame of a JAX engine and of the port, each resumed from it, agree."""
    path, cfg = jax_checkpoint
    data = np.load(path)
    meta = json.loads(str(data["__meta__"]))
    teng = tengine.Tendrils(convert.engine_config(cfg), seed=3,
                            device="cpu").setup()
    tio.load_checkpoint(path, teng)
    got = convert.sim_to_numpy(teng.sim)
    for name in SIM_FIELDS:
        np.testing.assert_array_equal(got[name], data[name], err_msg=name)
    assert got["idx"].dtype == np.int32
    assert teng.state == {**teng.state, **meta["state"]}
    assert teng.state["noiseScale"] == 2.5
    for k, v in meta["timer"].items():
        assert getattr(teng.timer, k) == v, k

    jeng = jengine.Tendrils(cfg, seed=3)
    jeng.setup()
    jio.load_checkpoint(path, jeng)
    jeng.frame()
    teng.frame()
    assert teng.timer.time == jeng.timer.time
    compare(teng.sim, sim_arrays(jeng.sim))


def test_port_checkpoint_layout_and_jax_load(tmp_path, jax_checkpoint):
    """The port writes the JAX layout: the same array names (the key that
    `jax.random.PRNGKey(seed)` gives included) and the same `__meta__`
    keys; the JAX package loads it field for field."""
    jpath, cfg = jax_checkpoint
    teng = tengine.Tendrils(convert.engine_config(cfg), seed=3,
                            device="cpu").setup()
    tio.load_checkpoint(jpath, teng)
    teng.frame()
    path = tio.save_checkpoint(str(tmp_path / "port.ckpt.npz"), teng)
    mine, theirs = np.load(path), np.load(jpath)
    assert sorted(mine.files) == sorted(theirs.files)
    np.testing.assert_array_equal(mine["key"], theirs["key"])
    np.testing.assert_array_equal(mine["key"],
                                  np.asarray(jax.random.PRNGKey(3)))
    m, t = (json.loads(str(d["__meta__"])) for d in (mine, theirs))
    assert {k: sorted(v) for k, v in m.items()} == \
        {k: sorted(v) for k, v in t.items()}
    assert m["config"] == t["config"]

    jeng = jengine.Tendrils(cfg, seed=3)
    jeng.setup()
    jio.load_checkpoint(path, jeng)
    for name in SIM_FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(jeng.sim, name)),
                                      mine[name], err_msg=name)
    assert jeng.timer.time == teng.timer.time
    assert isinstance(jeng.sim.particles, jnp.ndarray)


def test_load_follows_a_textured_colour_map(tmp_path):
    """A checkpoint of an engine with a textured colour map: the loading
    engine's `color_map_res` follows the map, so that its draw samples
    the map per particle as the saving engine's did (the JAX loader keeps
    the engine's config); the next frames are equal."""
    eng = _port_engine(16, (24, 32))
    spawn_ball(0.5, 0.01).spawn(eng)
    grid = np.random.default_rng(9).uniform(0, 1, (4, 6, 10)).astype(
        np.float32)
    eng.set_color_map(grid)
    eng.state["colorMapAlpha"] = 0.7
    eng.frame()
    path = tio.save_checkpoint(str(tmp_path / "cm.npz"), eng)
    eng2 = _port_engine(16, (24, 32))
    tio.load_checkpoint(path, eng2)
    assert eng2.config.color_map_res == (6, 10)
    # Both gather their first force in the step (the checkpoint has none).
    eng.sim = dataclasses.replace(eng.sim, force=None)
    for _ in range(2):
        eng.frame()
        eng2.frame()
    assert torch.equal(eng2.sim.view, eng.sim.view)
    assert torch.equal(eng2.sim.particles, eng.sim.particles)
