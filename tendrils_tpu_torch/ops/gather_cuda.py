"""Bilinear gathers of the flow grid, on hand-written CUDA kernels.

The port of `tendrils_tpu/ops/gather_pallas.py` for the slice:

  K4 `gather_reconstruct_p1` (csrc/gather.cu) per sorted row: the next
      step's force sampled at the packed p1, plus the resident-stream
      state reassembly (`draw_cuda.reconstruct_rows`);
  K5 `bilinear_gather`       (csrc/gather.cu) per point: CLAMP_TO_EDGE
      bilinear sampling at arbitrary pixel coords (`sample.bilinear_sample`
      is its plain version);
  K8 `bilinear_gather_keyed_p1` (csrc/gather.cu) per sorted row: K4's
      gather half alone, for frames that edit the flow between the draw
      and the gather (K4 == K8 + K6 `draw_cuda.reconstruct_resident`).

The TPU kernels sort points by tile, gather through MXU matmuls and
un-sort, because Mosaic has no vector gather; a per-point load computes the
same function, so neither kernel sorts. The keyed variants (tile keys
precomputed by the draw) need no keys here.
"""

import torch

from . import cuda_lib, sample
from .draw_cuda import reconstruct_rows
from .tile_geom import HALF, PAD_LO_H, PAD_LO_W

_F32 = torch.float32
_I32 = torch.int32


def bilinear_gather(grid, x, y):
    """K5: bilinearly sample `grid: f32[C, H, W]` at pixel coords `x`,
    `y: f32[M]` (same contract as `sample.bilinear_sample`, CLAMP_TO_EDGE).
    Returns `f32[C, M]`."""
    if cuda_lib.on_cpu(grid, x, y):
        return bilinear_gather_plain(grid, x, y)
    c, h, w = grid.shape
    m = x.shape[0]
    cuda_lib.check(grid, "grid", _F32, (c, h, w))
    cuda_lib.check(x, "x", _F32, (m,))
    cuda_lib.check(y, "y", _F32, (m,))
    out = torch.empty((c, m), dtype=_F32, device=grid.device)
    cuda_lib.launch("tt_bilinear_gather", "bilinear_gather", grid, c, h, w,
                    x, y, m, out)
    return out


def bilinear_gather_plain(grid, x, y):
    """Plain version of K5."""
    cuda_lib.plain_calls["bilinear_gather"] += 1
    return sample.bilinear_sample(grid, x, y)


def gather_reconstruct_p1(grid, p1_packed, npx, npy, vl, speed_limit, *,
                          inv_p):
    """K4: the resident frame's tail in one pass over the sorted streams.

    `grid`: the decayed flow `f32[2, H, W]` (content layout); `p1_packed`:
    `i32[M]` fixed-point p1 words at `1/inv_p` px; `npx`, `npy`: `f32[M]`
    exact sorted positions; `vl`: `i32[M]` q15 velocity words;
    `speed_limit`: the (clamped) speedLimit. Returns `(force f32[2, M],
    particles f32[4, M], previous f32[4, M])` in sorted (= new row) order.
    (The JAX function also takes the draw's tile keys and optional targets;
    the port needs no keys and does not ride live targets yet.)"""
    sl = torch.as_tensor(speed_limit, dtype=_F32,
                         device=grid.device).reshape(1)
    if cuda_lib.on_cpu(grid, p1_packed, npx, npy, vl, sl):
        return gather_reconstruct_plain(grid, p1_packed, npx, npy, vl, sl,
                                        inv_p=inv_p)
    _, h, w = grid.shape
    m = p1_packed.shape[0]
    cuda_lib.check(grid, "grid", _F32, (2, h, w))
    cuda_lib.check(p1_packed, "p1_packed", _I32, (m,))
    cuda_lib.check(npx, "npx", _F32, (m,))
    cuda_lib.check(npy, "npy", _F32, (m,))
    cuda_lib.check(vl, "vl", _I32, (m,))
    force = torch.empty((2, m), dtype=_F32, device=grid.device)
    particles = torch.empty((4, m), dtype=_F32, device=grid.device)
    previous = torch.empty((4, m), dtype=_F32, device=grid.device)
    cuda_lib.launch("tt_gather_reconstruct", "gather_reconstruct", grid, h,
                    w, p1_packed, npx, npy, vl, sl, m, float(inv_p), force,
                    particles, previous)
    return force, particles, previous


def gather_reconstruct_plain(grid, p1_packed, npx, npy, vl, speed_limit, *,
                             inv_p):
    """Plain version of K4: the gather half (`_gather_p1`), then the
    reassembly (`reconstruct_rows`)."""
    cuda_lib.plain_calls["gather_reconstruct"] += 1
    return (_gather_p1(grid, p1_packed, inv_p),
            *reconstruct_rows(speed_limit, npx, npy, vl))


def _gather_p1(grid, p1_packed, inv_p):
    """Unpack + CLAMP_TO_EDGE p1 (gather_pallas.py:107-112, 516-517) and
    sample `grid` there."""
    _, h, w = grid.shape
    x = torch.clamp((p1_packed & HALF).to(_F32) * inv_p, PAD_LO_W + 0.5,
                    PAD_LO_W + w - 0.5) - PAD_LO_W
    y = torch.clamp((p1_packed >> 15).to(_F32) * inv_p, PAD_LO_H + 0.5,
                    PAD_LO_H + h - 0.5) - PAD_LO_H
    return sample.bilinear_sample(grid, x, y)


def bilinear_gather_keyed_p1(grid, p1_packed, *, inv_p):
    """K8: sample `grid: f32[C, H, W]` (content layout) at the packed p1
    words `i32[M]` (`1/inv_p` px, padded coordinates), CLAMP_TO_EDGE.
    Returns the exact `f32[C, M]` in input (sorted = new row) order. (The
    JAX function also takes the draw's tile keys; the port needs none.)"""
    if cuda_lib.on_cpu(grid, p1_packed):
        return bilinear_gather_keyed_p1_plain(grid, p1_packed, inv_p=inv_p)
    c, h, w = grid.shape
    m = p1_packed.shape[0]
    cuda_lib.check(grid, "grid", _F32, (c, h, w))
    cuda_lib.check(p1_packed, "p1_packed", _I32, (m,))
    out = torch.empty((c, m), dtype=_F32, device=grid.device)
    cuda_lib.launch("tt_gather_keyed_p1", "gather_keyed_p1", grid, c, h, w,
                    p1_packed, m, float(inv_p), out)
    return out


def bilinear_gather_keyed_p1_plain(grid, p1_packed, *, inv_p):
    """Plain version of K8: the gather half of K4's."""
    cuda_lib.plain_calls["gather_keyed_p1"] += 1
    return _gather_p1(grid, p1_packed, inv_p)
