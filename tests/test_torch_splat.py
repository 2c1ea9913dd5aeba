"""The port's segment splat (`ops/splat.py`) and point splat K9
(`ops/splat_cuda.py`, its plain version on the CPU) against the JAX
package's XLA scatter (`ops/splat.py`) and Pallas splat
(`ops/splat_pallas.py`, interpret mode), on the same seeded inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tendrils_tpu.ops import splat as jsplat
from tendrils_tpu.ops.splat_pallas import splat_accumulate as jsplat_pallas
from tendrils_tpu_torch.ops import cuda_lib, splat as tsplat, splat_cuda

pytestmark = pytest.mark.kernel  # runs the JAX Pallas kernels (pytest.ini)

# K9's plain version makes the XLA scatter's f32 products and adds them in
# another order: relative 1e-5, with an absolute floor for the signed
# payload sums near 0.
RTOL, ATOL = 1e-5, 1e-6
# The Pallas kernel samples in padded coordinates (x + PAD_LO_W), which
# rounds away bits of the texel fraction, and sums one-hot matmul rows; the
# JAX package holds it to its XLA oracle at 1e-4 (tests/test_splat_pallas.py).
PALLAS_TOL = 1e-4


def _edge_samples(h, w):
    """Samples on, just past (within 1 px) and far past every edge, in
    both axes."""
    xs = np.asarray([-3, -1, -0.75, -0.5, -0.25, 0, 0.25, 0.5, 3.3,
                     w - 0.5, w - 0.25, w, w + 0.25, w + 0.5, w + 0.75,
                     w + 1, w + 3], np.float32)
    ys = np.asarray([-3, -1, -0.75, -0.5, -0.25, 0, 0.25, 0.5, 2.7,
                     h - 0.5, h - 0.25, h, h + 0.25, h + 0.5, h + 0.75,
                     h + 1, h + 3], np.float32)
    x, y = np.meshgrid(xs, ys)
    return x.reshape(-1), y.reshape(-1)


def _case(kind, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "dense":
        (h, w), m = (64, 256), 4096
        x = rng.uniform(-2, w + 2, m).astype(np.float32)
        y = rng.uniform(-2, h + 2, m).astype(np.float32)
    elif kind == "sparse":
        (h, w), m = (128, 384), 300
        x = rng.uniform(-2, w + 2, m).astype(np.float32)
        y = rng.uniform(-2, h + 2, m).astype(np.float32)
    else:  # the edges, plus a cluster piling onto a few texels
        h, w = 32, 128
        ex, ey = _edge_samples(h, w)
        x = np.concatenate([ex, rng.normal(100.0, 2.0, 500)])
        y = np.concatenate([ey, rng.normal(20.0, 2.0, 500)])
        x, y = x.astype(np.float32), y.astype(np.float32)
    m = x.size
    vals = rng.uniform(-1, 1, (4, m)).astype(np.float32)
    alpha = rng.uniform(0, 0.9, m).astype(np.float32)
    alpha[::7] = 0.0  # masked rows and pad segments deposit nothing
    alpha[::11] = 1.0  # log1p is clamped at 1 - 1e-4
    return (h, w), x, y, vals, alpha


@pytest.mark.parametrize("kind", ["dense", "sparse", "edges"])
def test_splat_accumulate_matches_jax(kind):
    grid_hw, x, y, vals, alpha = _case(kind)
    cuda_lib.reset_counts()
    tout = splat_cuda.splat_accumulate(grid_hw, *(torch.as_tensor(a) for a in
                                                  (x, y, vals, alpha)))
    assert cuda_lib.plain_calls["splat_points"] == 1
    j = [jnp.asarray(a) for a in (x, y, vals, alpha)]
    xla = jsplat.splat_accumulate_xla(grid_hw, *j)
    pallas = jsplat_pallas(grid_hw, *j, interpret=True)
    for name, t, a, b in zip(("num", "wsum", "logt"), tout, xla, pallas):
        assert tuple(t.shape) == a.shape
        np.testing.assert_allclose(t.numpy(), np.asarray(a), rtol=RTOL,
                                   atol=ATOL, err_msg=name)
        np.testing.assert_allclose(t.numpy(), np.asarray(b),
                                   rtol=PALLAS_TOL, atol=PALLAS_TOL,
                                   err_msg=name)
        assert np.abs(t.numpy()).sum() > 0


def test_offgrid_samples_deposit_nothing():
    """Samples more than 1 px outside the grid add nothing; one within it
    adds its in-grid corners only."""
    h, w = 32, 128
    x = torch.tensor([-1.5, -0.75, w + 1.0, w + 40.0, 5.0, -500.0])
    y = torch.tensor([5.0, 5.0, 5.0, 5.0, h + 1.0, 1000.0])
    one = torch.ones(x.shape[0])
    num, wsum, logt = splat_cuda.splat_accumulate((h, w), x, y, one[None],
                                                  one)
    assert wsum.abs().sum() == 0 and num.abs().sum() == 0
    assert logt.abs().sum() == 0
    # x = -0.25: corner column -1 is dropped, column 0 gets weight 0.25.
    num, wsum, _ = splat_cuda.splat_accumulate(
        (h, w), torch.tensor([-0.25]), torch.tensor([5.5]),
        torch.ones(1, 1), torch.ones(1))
    assert wsum.sum().item() == pytest.approx(0.25)
    assert wsum[5, 0].item() == pytest.approx(0.25)


@pytest.mark.parametrize("samples,rows,width", [(2, 1, 1.0), (4, 3, 2.5),
                                                (3, 5, 0.5)])
def test_segment_samples_matches_jax(samples, rows, width):
    rng = np.random.default_rng(5)
    p0 = rng.uniform(-4, 70, (40, 2)).astype(np.float32)
    p1 = p0 + rng.uniform(-9, 9, (40, 2)).astype(np.float32)
    p1[:3] = p0[:3]  # zero-length segments
    alpha = rng.uniform(0, 1, 40).astype(np.float32)
    j = jsplat.segment_samples(jnp.asarray(p0), jnp.asarray(p1),
                               jnp.asarray(alpha), samples, rows,
                               jnp.float32(width))
    t = tsplat.segment_samples(torch.as_tensor(p0), torch.as_tensor(p1),
                               torch.as_tensor(alpha), samples, rows,
                               torch.tensor(width))
    for a, b in zip(t, j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-6)


@pytest.mark.parametrize("premultiplied", [False, True])
def test_splat_segments_matches_jax(premultiplied):
    """The whole segment splat over a grid: the port (K9's plain version
    on CPU tensors) against both JAX backends, XLA and Pallas."""
    rng = np.random.default_rng(6)
    h, w = 32, 128
    p0 = np.stack([rng.uniform(-3, w + 3, 60), rng.uniform(-3, h + 3, 60)],
                  axis=-1).astype(np.float32)
    p1 = p0 + rng.uniform(-6, 6, (60, 2)).astype(np.float32)
    vals = rng.uniform(-0.01, 0.01, (4, 60)).astype(np.float32)
    alpha = rng.uniform(0, 0.8, 60).astype(np.float32)
    dst = rng.uniform(-0.01, 0.01, (4, h, w)).astype(np.float32)
    kw = dict(grid_hw=(h, w), width=3.0, samples=2, rows=3,
              premultiplied=premultiplied)
    j = [jnp.asarray(a) for a in (dst, p0, p1, vals, alpha)]
    jx = np.asarray(jsplat.splat_segments(*j, backend="xla", **kw))
    jp = np.asarray(jsplat.splat_segments(*j, backend="pallas", **kw))
    t = [torch.as_tensor(a) for a in (dst, p0, p1, vals, alpha)]
    cuda_lib.reset_counts()
    tk = tsplat.splat_segments(*t, **kw).numpy()
    assert cuda_lib.plain_calls["splat_points"] == 1
    assert not np.array_equal(tk, dst)
    np.testing.assert_allclose(tk, jx, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tk, jp, rtol=PALLAS_TOL, atol=PALLAS_TOL)
