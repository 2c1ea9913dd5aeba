"""The port's state module against the JAX package's (exact), and the
`convert` round trip."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tendrils_tpu import engine as jengine, state as jstate
from tendrils_tpu_torch import convert, engine as tengine, state as tstate


def test_default_state_and_params_match():
    assert tstate.default_state() == jstate.default_state()
    jp = jstate.params_from_state(jstate.default_state())
    tp = tstate.params_from_state(tstate.default_state())
    assert jp.keys() == tp.keys()
    for k in jp:
        np.testing.assert_array_equal(tp[k].numpy(), np.asarray(jp[k]))


@pytest.mark.parametrize("kw", [
    dict(root_num=16, view_res=(32, 128)),
    dict(root_num=8, view_res=(24, 40), num_view_buffers=2,
         color_map_res=(3, 5), flow_res=(12, 20)),
])
def test_make_state_matches(kw):
    j = jstate.make_state(**kw)
    t = tstate.make_state(**kw)
    for f in ("particles", "previous", "targets", "flow", "view", "color_map",
              "idx"):
        a, b = getattr(t, f).numpy(), np.asarray(getattr(j, f))
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert t.force is None


@pytest.mark.parametrize("root", [16, 24, 1024])
def test_particle_coords_from_idx_exact(root):
    rng = np.random.default_rng(root)
    idx = rng.permutation(root * root).astype(np.int32)
    j = jstate.particle_coords_from_idx(jnp.asarray(idx), root)
    t = tstate.particle_coords_from_idx(torch.as_tensor(idx), root)
    for a, b in zip(t, j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_convert_round_trip():
    jcfg = jengine.EngineConfig(root_num=8, view_res=(16, 128),
                                splat_backend="pallas",
                                gather_backend="pallas")
    # "pallas" maps to the port's "kernel", every other field is copied.
    assert convert.engine_config(jcfg) == tengine.EngineConfig(
        root_num=8, view_res=(16, 128))
    rng = np.random.default_rng(0)
    jsim = jstate.make_state(8, (16, 128))
    arrays = {f.name: (None if getattr(jsim, f.name) is None
                       else np.asarray(getattr(jsim, f.name)))
              for f in dataclasses.fields(jsim)}
    arrays["particles"] = rng.normal(size=(4, 64)).astype(np.float32)
    arrays["idx"] = rng.permutation(64).astype(np.int32)
    arrays["force"] = rng.normal(size=(2, 64)).astype(np.float32)
    sim = convert.sim_from_numpy(arrays)
    assert sim.idx.dtype == torch.int32
    back = convert.sim_to_numpy(sim)
    for k, v in back.items():
        np.testing.assert_array_equal(v, arrays[k], err_msg=k)
    params = {k: np.asarray(v) for k, v in jengine.default_params().items()}
    tparams = convert.params_from_numpy(params)
    for k, v in convert.params_to_numpy(tparams).items():
        np.testing.assert_array_equal(v, params[k])
