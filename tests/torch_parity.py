"""Helpers of the tests that hold the port's frames to the JAX engine's
(`tests/test_torch_*.py`): states handed over through numpy, a port
engine on the CPU holding a JAX state, and the comparison of two states.

Particles are compared by identity (`sim.idx` inverted on each side: a
one-ulp move may legitimately move a row in the sort), grids with the
reference's own cross-path tolerance (tests/test_fused_draw.py: the splat
sums bf16 products on the TPU side and f32 on the port's, which moves a
deposit by a texel fraction).
"""

import dataclasses

import numpy as np

from tendrils_tpu_torch import convert, engine as tengine


def sim_arrays(sim):
    """A JAX SimState as a dict of numpy arrays (None kept)."""
    return {f.name: (None if getattr(sim, f.name) is None
                     else np.array(getattr(sim, f.name)))
            for f in dataclasses.fields(sim)}


def port_engine(jax_cfg, arrays, time, **cfg_kw):
    """A port facade on the CPU with the JAX config (fields replaced by
    `cfg_kw`), holding the state `arrays` at timer time `time`."""
    t = tengine.Tendrils(convert.engine_config(
        dataclasses.replace(jax_cfg, **cfg_kw)), device="cpu")
    t.setup()
    t.sim = convert.sim_from_numpy(arrays, device="cpu")
    t.timer.time = time
    return t


def _smooth(img):
    k = np.ones(3) / 3
    img = np.apply_along_axis(lambda v: np.convolve(v, k, "same"), -1, img)
    return np.apply_along_axis(lambda v: np.convolve(v, k, "same"), -2, img)


def compare(tsim, want, force_rtol=0.0):
    """The port's state against a JAX state (`sim_arrays`): particles,
    previous and the carried force by identity (atol 1e-4; the force also
    within `force_rtol`), flow and view 1-px smoothed within rtol 5e-2 /
    atol 2e-2 with totals within 1e-3, and signs of life."""
    def by_id(rows, idx):
        return rows[:, np.argsort(idx)]

    got = convert.sim_to_numpy(tsim)
    np.testing.assert_array_equal(np.sort(got["idx"]),
                                  np.arange(got["idx"].size))
    for name in ("particles", "previous", "force"):
        if want[name] is None:
            assert got[name] is None, name
            continue
        np.testing.assert_allclose(
            by_id(got[name], got["idx"]), by_id(want[name], want["idx"]),
            rtol=force_rtol if name == "force" else 0.0, atol=1e-4,
            err_msg=name)
    for name in ("flow", "view"):
        np.testing.assert_allclose(_smooth(got[name]), _smooth(want[name]),
                                   rtol=5e-2, atol=2e-2, err_msg=name)
        np.testing.assert_allclose(got[name].sum(), want[name].sum(),
                                   rtol=1e-3, err_msg=name)
    assert (got["particles"][0] > -9e5).any()
    assert (got["flow"][3] > 1e-3).any()
