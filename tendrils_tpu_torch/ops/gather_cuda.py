"""Bilinear gathers of the flow grid, on hand-written CUDA kernels.

The port of `tendrils_tpu/ops/gather_pallas.py` for the slice:

  K4 `gather_reconstruct_p1` (csrc/gather.cu) per sorted row: the next
      step's force sampled at the packed p1, plus the resident-stream
      state reassembly (`draw_cuda.reconstruct_rows`) and, with live
      targets riding the sort, the targets re-stacked;
  K5 `bilinear_gather`       (csrc/gather.cu) per point: CLAMP_TO_EDGE
      bilinear sampling at arbitrary pixel coords (`sample.bilinear_sample`
      is its plain version), each pair of channels interleaved into one
      texel-major copy first;
  K8 `bilinear_gather_keyed_p1` (csrc/gather.cu) per sorted row: K4's
      gather half alone, for frames that edit the flow between the draw
      and the gather (K4 == K8 + K6 `draw_cuda.reconstruct_resident`);
  K7 `bilinear_gather_keyed_q15` (csrc/gather.cu) per sorted row: K8's
      gather of the decayed flow, packed as two q15 fields over
      +-speedLimit, the word the non-resident frame un-sorts;
  K12 `bilinear_gather_keyed` (csrc/gather.cu) per point: the gather at
      padded-grid float coords.

The TPU kernels sort points by tile, gather through MXU matmuls and
un-sort, because Mosaic has no vector gather; a per-point load computes the
same function, so no kernel here sorts. The keyed variants (tile keys
precomputed by the draw) need no keys here.
"""

import torch

from . import cuda_lib, sample
from .draw_cuda import check_targets, reconstruct_rows, targets_counter
from .tile_geom import HALF, PAD_LO_H, PAD_LO_W

_F32 = torch.float32
_I32 = torch.int32
# K7, K8 and K12: threads a block (csrc/gather.cu KEYED_THREADS) and the
# most rows a thread takes.
KEYED_THREADS = 1024
KEYED_MAX_ROWS = 8
# K5's interleaved pair, one per (h, w, device), reused by every call: the
# kernels run in stream order, so a call's copy is read before the next
# call's overwrites it.
_pairs = {}


def keyed_layout(n, sms):
    """`(r, blocks)` of K7, K8 and K12 on `n` sorted rows: `r` rows a thread,
    min(8, max(1, ceil(n / (sms x KEYED_THREADS)))), so that the rows fill
    the card's `sms` SMs before a block's span grows; one block a span of
    KEYED_THREADS x r consecutive rows, at most two waves of two blocks an
    SM (the blocks stride over the rest)."""
    r = min(KEYED_MAX_ROWS, max(1, -(-n // (sms * KEYED_THREADS))))
    return r, max(1, min(-(-n // (KEYED_THREADS * r)), 2 * sms))


def _keyed_launch(device, n):
    return keyed_layout(n, torch.cuda.get_device_properties(
        device).multi_processor_count)


def _pair_scratch(h, w, device):
    """K5's f32[H, W, 2] scratch for `device`, allocated once."""
    key = (h, w, device)
    if key not in _pairs:
        _pairs[key] = torch.empty((h, w, 2), dtype=_F32, device=device)
    return _pairs[key]


def bilinear_gather(grid, x, y):
    """K5: bilinearly sample `grid: f32[C, H, W]` at pixel coords `x`,
    `y: f32[M]` (same contract as `sample.bilinear_sample`, CLAMP_TO_EDGE).
    Returns `f32[C, M]`. One C call, C kernel launches: two for each pair
    of channels (the pair's planes interleaved into a scratch copy, then
    the gather), one for an odd last channel."""
    if cuda_lib.on_cpu(grid, x, y):
        return bilinear_gather_plain(grid, x, y)
    c, h, w = grid.shape
    m = x.shape[0]
    cuda_lib.check(grid, "grid", _F32, (c, h, w))
    cuda_lib.check(x, "x", _F32, (m,))
    cuda_lib.check(y, "y", _F32, (m,))
    if h * w >= 2 ** 31:
        raise ValueError(f"a {h}x{w} plane has 2^31 texels or more; the "
                         "kernels index a plane with 32-bit offsets")
    out = torch.empty((c, m), dtype=_F32, device=grid.device)
    pair = _pair_scratch(h, w, grid.device) if c > 1 else None
    cuda_lib.launch("tt_bilinear_gather", "bilinear_gather", grid, c, h, w,
                    x, y, m, pair, out, kernels=c)
    return out


def bilinear_gather_plain(grid, x, y):
    """Plain version of K5."""
    cuda_lib.plain_calls["bilinear_gather"] += 1
    return sample.bilinear_sample(grid, x, y)


def gather_reconstruct_p1(grid, p1_packed, npx, npy, vl, speed_limit,
                          tx=None, ty=None, *, inv_p):
    """K4: the resident frame's tail in one pass over the sorted streams.

    `grid`: the decayed flow `f32[2, H, W]` (content layout); `p1_packed`:
    `i32[M]` fixed-point p1 words at `1/inv_p` px; `npx`, `npy`: `f32[M]`
    exact sorted positions; `vl`: `i32[M]` q15 velocity words;
    `speed_limit`: the (clamped) speedLimit; `tx`, `ty`: `f32[M]` the live
    targets when they rode the sort. Returns `(force f32[2, M], particles
    f32[4, M], previous f32[4, M][, targets f32[4, M]])` in sorted (= new
    row) order, the targets re-stacked as `(tx, ty, 0, 0)`
    (`gather_pallas.py:481-550`). A launch with the targets counts as
    `gather_reconstruct_targets`. (The JAX function also takes the draw's
    tile keys; the port needs none.)"""
    sl = torch.as_tensor(speed_limit, dtype=_F32,
                         device=grid.device).reshape(1)
    targ = () if tx is None else (tx, ty)
    if cuda_lib.on_cpu(grid, p1_packed, npx, npy, vl, sl, *targ):
        return gather_reconstruct_plain(grid, p1_packed, npx, npy, vl, sl,
                                        tx, ty, inv_p=inv_p)
    _, h, w = grid.shape
    m = p1_packed.shape[0]
    cuda_lib.check(grid, "grid", _F32, (2, h, w))
    cuda_lib.check(p1_packed, "p1_packed", _I32, (m,))
    cuda_lib.check(npx, "npx", _F32, (m,))
    cuda_lib.check(npy, "npy", _F32, (m,))
    cuda_lib.check(vl, "vl", _I32, (m,))
    check_targets(tx, ty, m)
    force = torch.empty((2, m), dtype=_F32, device=grid.device)
    rec = [torch.empty((4, m), dtype=_F32, device=grid.device)
           for _ in range(2 if tx is None else 3)]
    cuda_lib.launch("tt_gather_reconstruct",
                    targets_counter("gather_reconstruct", tx), grid, h, w,
                    p1_packed, npx, npy, vl, sl, tx, ty, m, float(inv_p),
                    force, rec[0], rec[1], rec[2] if len(rec) == 3 else None)
    return (force, *rec)


def gather_reconstruct_plain(grid, p1_packed, npx, npy, vl, speed_limit,
                             tx=None, ty=None, *, inv_p):
    """Plain version of K4: the gather half (`_gather_p1`), then the
    reassembly (`reconstruct_rows`)."""
    cuda_lib.plain_calls[targets_counter("gather_reconstruct", tx)] += 1
    return (_gather_p1(grid, p1_packed, inv_p),
            *reconstruct_rows(speed_limit, npx, npy, vl, tx, ty))


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
                    p1_packed, m, *_keyed_launch(grid.device, m),
                    float(inv_p), out)
    return out


def bilinear_gather_keyed_p1_plain(grid, p1_packed, *, inv_p):
    """Plain version of K8: the gather half of K4's."""
    cuda_lib.plain_calls["gather_keyed_p1"] += 1
    return _gather_p1(grid, p1_packed, inv_p)


def bilinear_gather_keyed_q15(grid, p1_packed, inv_sl, *, inv_p):
    """K7: sample the decayed flow `grid: f32[2, H, W]` (content layout) at
    the packed p1 words `i32[M]` (`1/inv_p` px, padded coordinates),
    CLAMP_TO_EDGE, and pack the force as `q(fy) * (HALF + 1) + q(fx)`,
    `q(v) = round((clip(v * inv_sl, -1, 1) * 0.5 + 0.5) * HALF)`. `inv_sl`:
    the device f32 `1 / max(speedLimit, 1e-12)`. Returns `i32[M]` in input
    (sorted) order. (The JAX function also takes the draw's tile keys; the
    port needs none.)"""
    inv_sl = torch.as_tensor(inv_sl, dtype=_F32,
                             device=grid.device).reshape(1)
    if cuda_lib.on_cpu(grid, p1_packed, inv_sl):
        return bilinear_gather_keyed_q15_plain(grid, p1_packed, inv_sl,
                                               inv_p=inv_p)
    _, h, w = grid.shape
    m = p1_packed.shape[0]
    cuda_lib.check(grid, "grid", _F32, (2, h, w))
    cuda_lib.check(p1_packed, "p1_packed", _I32, (m,))
    out = torch.empty(m, dtype=_I32, device=grid.device)
    cuda_lib.launch("tt_gather_keyed_q15", "gather_keyed_q15", grid, h, w,
                    p1_packed, inv_sl, m, *_keyed_launch(grid.device, m),
                    float(inv_p), out)
    return out


def bilinear_gather_keyed_q15_plain(grid, p1_packed, inv_sl, *, inv_p):
    """Plain version of K7: K8's gather (`_gather_p1`), then the q15 pack
    (gather_pallas.py:222-232)."""
    cuda_lib.plain_calls["gather_keyed_q15"] += 1
    f = _gather_p1(grid, p1_packed, inv_p)

    def q(v):
        t = torch.clamp(v * inv_sl, -1.0, 1.0) * 0.5 + 0.5
        return torch.round(t * HALF).to(_I32)

    return q(f[1]) * (HALF + 1) + q(f[0])


def bilinear_gather_keyed(grid, xs, ys):
    """K12: sample `grid: f32[C, H, W]` (content layout) at padded-grid
    pixel coords `xs`, `ys: f32[M]` (content coords + PAD_LO_W, PAD_LO_H),
    bilinearly, a corner outside the content weighing 0; on points within
    half a texel of the content's edge texel centres, as every caller
    clamps them, this is CLAMP_TO_EDGE sampling. Returns `f32[C, M]` in
    input order. The points are the draw's tile-sorted stream (the JAX
    function's contract), taken in K7's blocks of consecutive points
    (`keyed_layout`). (The JAX function also takes each point's tile key,
    which its tile-binned matmuls need; the port's per-point loads need
    none.)"""
    if cuda_lib.on_cpu(grid, xs, ys):
        return bilinear_gather_keyed_plain(grid, xs, ys)
    c, h, w = grid.shape
    m = xs.shape[0]
    cuda_lib.check(grid, "grid", _F32, (c, h, w))
    cuda_lib.check(xs, "xs", _F32, (m,))
    cuda_lib.check(ys, "ys", _F32, (m,))
    out = torch.empty((c, m), dtype=_F32, device=grid.device)
    cuda_lib.launch("tt_gather_keyed", "gather_keyed", grid, c, h, w, xs, ys,
                    m, *_keyed_launch(grid.device, m), out)
    return out


def bilinear_gather_keyed_plain(grid, xs, ys):
    """Plain version of K12, with the TPU kernel's arithmetic (weights `1 -
    frac` and `1 -` that, gather_pallas.py:113-118; rows summed, then
    across rows)."""
    cuda_lib.plain_calls["gather_keyed"] += 1
    c, h, w = grid.shape
    gx = xs - 0.5
    gy = ys - 0.5
    c0f = torch.floor(gx)
    r0f = torch.floor(gy)
    wx0 = 1.0 - (gx - c0f)
    wy0 = 1.0 - (gy - r0f)
    wx1 = 1.0 - wx0
    wy1 = 1.0 - wy0
    c0 = c0f.to(torch.int64) - PAD_LO_W
    r0 = r0f.to(torch.int64) - PAD_LO_H
    flat = grid.reshape(c, h * w)

    def texel(r, cc):
        ok = (r >= 0) & (r < h) & (cc >= 0) & (cc < w)
        v = flat[:, torch.clamp(r, 0, h - 1) * w + torch.clamp(cc, 0, w - 1)]
        return torch.where(ok, v, 0.0)

    top = texel(r0, c0) * wx0 + texel(r0, c0 + 1) * wx1
    bot = texel(r0 + 1, c0) * wx0 + texel(r0 + 1, c0 + 1) * wx1
    return top * wy0 + bot * wy1
