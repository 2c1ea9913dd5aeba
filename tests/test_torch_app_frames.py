"""The port's demo frame against the JAX demo's: `TendrilsDemo.render()`
for four presets that take different paths through the io frame, from
one converted state, fed the same camera frames and pointers.

- `Flow`: the resident io frame with colour maps, K6 + K8 after the
  pointer lines (K9) and the camera's optical flow; the vignette blur.
- `Tornado Alley`, after `set_image`: its `spawnImageTargets` makes the
  targets live (`target` 0.003), so they ride the sort (K6 with targets).
- `Pissarides`: `clear` and `respawn` actions, a line width of 20 (the
  resolve's XLA tail), the heaviest blur (radius 12, limit 0.3).
- `Noise Only`: `flowWeight 0`, so the step gathers no force.

The JAX demo runs with `splat_backend="pallas", gather_backend="pallas"`
(its Pallas kernels in interpret mode, as tests/test_torch_frame_io.py
runs them); after `apply_preset` on both sides its state is handed to the
port's demo through `convert`, and both render FRAMES frames.

Tolerance: the state as tests/test_torch_frame_io.py holds an io frame
(`torch_parity.compare`, the force within rtol 2e-3: the JAX splat sums a
transmittance from bf16 operands, ~5e-4 of the flow), and the screens
with the grid tolerance of tests/test_torch_post.py (1-px smoothed, rtol
5e-2 / atol 2e-2; the JAX blur runs its banded matmuls, the port its
windowed boxes). `Pissarides` paints lines 20 px wide, which the resolve
widens over 16 times the texels of a 5-px line, and so 16 times the bf16
roundings: its force is held within rtol 1e-2 (measured at most 4.8e-3;
the same preset at 5 px reads 1.5e-3, and the flow grids stay within the
reference's own cross-path bound, tests/test_fused_draw.py).
"""

import numpy as np
import pytest
import torch

from tendrils_tpu.app import demo as jdemo
from tendrils_tpu_torch import convert
from tendrils_tpu_torch.app import demo as tdemo
from tendrils_tpu_torch.ops import cuda_lib
from torch_parity import _smooth, compare, sim_arrays

pytestmark = pytest.mark.kernel  # runs the JAX Pallas kernels (pytest.ini)

CFG = dict(view_res=(32, 128), root_num=16, flow_samples=2, flow_rows=1,
           view_samples=2)
CAM = (24, 64)  # camera frames (H, W)
FRAMES = 3
FORCE_RTOL = {"Pissarides": 1e-2}


def _camera(i):
    """Camera frame `i`: a bright bar moving right."""
    img = np.zeros((*CAM, 3), np.uint8)
    img[:, 6 * i + 10:6 * i + 20] = 255
    return img


def _still(seed=0):
    return np.random.default_rng(seed).uniform(0, 255, (*CAM, 3)).astype(
        np.uint8)


@pytest.mark.parametrize("preset", ["Flow", "Tornado Alley", "Pissarides",
                                    "Noise Only"])
def test_demo_frames_match_jax(preset):
    jd = jdemo.TendrilsDemo({}, splat_backend="pallas",
                            gather_backend="pallas", **CFG)
    td = tdemo.TendrilsDemo({}, device="cpu", **CFG)
    for d in (jd, td):
        if preset == "Tornado Alley":
            d.set_image(_still())
        d.apply_preset(preset)
    td.tendrils.sim = convert.sim_from_numpy(sim_arrays(jd.tendrils.sim),
                                             device="cpu")
    assert td.timer["app"].time == jd.timer["app"].time
    assert td.tendrils._targets_live == jd.tendrils._targets_live
    cuda_lib.reset_counts()
    for i in range(FRAMES):
        for d in (jd, td):
            d.feed_video_frame(_camera(i))
            d.pointer_move(0, 20.0 + 12 * i, 10.0)
            d.pointer_move(1, 100.0 - 12 * i, 22.0)
            d.render()
    assert td.timer["app"].time == jd.timer["app"].time
    compare(td.tendrils.sim, sim_arrays(jd.tendrils.sim),
            force_rtol=FORCE_RTOL.get(preset, 2e-3))
    h, w = CFG["view_res"]
    screen = td.screen
    assert tuple(screen.shape) == (4, h, w) and torch.isfinite(screen).all()
    np.testing.assert_allclose(_smooth(screen.numpy()),
                               _smooth(np.asarray(jd.screen)),
                               rtol=5e-2, atol=2e-2)
    calls = cuda_lib.plain_calls
    assert calls["splat_points"] > 0  # the pointer lines
    if preset == "Noise Only":
        assert td.tendrils.sim.force is None
        assert calls["bilinear_gather"] == calls["gather_keyed_p1"] == 0
    else:
        assert calls["gather_keyed_p1"] == FRAMES
    targets = calls["reconstruct_resident_targets"]
    assert targets == (FRAMES if td.tendrils._targets_live else 0)
