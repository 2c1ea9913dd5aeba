"""The generic point splat (K9), on a hand-written CUDA kernel.

The port of `tendrils_tpu/ops/splat_pallas.py`: `splat_accumulate` adds M
bilinear points with C payload channels into `(num f32[C, H, W], wsum
f32[H, W], logt f32[H, W])` (csrc/splat_points.cu: int64 fixed-point
atomics into an unpadded scratch, converted to f32, so every call with the
same inputs gives the same bits). `splat_accumulate_plain` is its plain
version: the same deposits quantised at the same steps and summed in
int64 with `index_add_` (`fixed_point`), so the same bits; the wrapper
takes it for CPU tensors only. The f32 scatter of the JAX package's xla
backend is `splat.splat_accumulate_xla`, which no kernel stands in for.
The TPU kernel's tile sort, padded margin and "moved => alpha 0" rule
exist for its region DMAs and compute the same function as the
per-corner validity test both versions here use.

The kernel's int64 scratch is kept, one per `(C, H, W, device, stream)`:
allocated zeroed once, and left all zero by every call (the conversion
zeroes what it reads). Beside it are the tiles' marks (`i32`, one per
TILE_H x TILE_W tile) and a call counter, the epoch: a call marks the
tiles its samples reach with its epoch, so only those are read and zeroed,
and no mark needs clearing. Calls on one stream run in order, so each
finds the scratch its predecessor left zero; a call on another stream gets
a scratch of its own. If a launch raises, the kept scratch is dropped and
the next call allocates a zeroed one.
"""

import torch

from . import cuda_lib, fixed_point
from .splat import _bilinear_corners

_F32 = torch.float32
# Kernels one `splat_accumulate` call launches with samples (the channel
# bounds, the fixed-point adds and marks, the conversion); without, the
# conversion.
SPLAT_POINTS_LAUNCHES = 3
# csrc/splat_points.cu: POINT_TILE_H x POINT_TILE_W tiles.
TILE_H = 8
TILE_W = 16
# Blocks of the grid-stride conversion an SM: 8 x 256 threads fill one.
CONVERT_BLOCKS_PER_SM = 8
_EPOCH_MAX = 2 ** 31 - 1
# (C, H, W, device, stream) -> the kept scratch: {"fix", "marks", "bits",
# "epoch"}.
_kept = {}


def tile_grid(h, w):
    """`(tiles down, tiles across)` of an H x W grid, partial edge tiles
    included."""
    return -(-h // TILE_H), -(-w // TILE_W)


def convert_blocks(sms):
    """The most blocks of K9's conversion on a card of `sms` SMs."""
    return sms * CONVERT_BLOCKS_PER_SM


def _stream():
    """The current CUDA stream's handle, which keys the kept scratch."""
    return torch.cuda.current_stream().cuda_stream


def _scratch(c, h, w, device, stream):
    """The kept scratch of `(c, h, w, device, stream)`, its epoch advanced
    for this call (the marks re-zeroed when the counter wraps)."""
    key = (c, h, w, device, stream)
    s = _kept.get(key)
    if s is None:
        th, tw = tile_grid(h, w)
        s = _kept[key] = dict(
            fix=torch.zeros((c + 2, h, w), dtype=torch.int64, device=device),
            marks=torch.zeros(th * tw, dtype=torch.int32, device=device),
            bits=torch.empty(c + 2, dtype=torch.int32, device=device),
            epoch=0)
    s["epoch"] += 1
    if s["epoch"] > _EPOCH_MAX:
        s["marks"].zero_()
        s["epoch"] = 1
    return s


def splat_accumulate(grid_hw, x, y, values, alpha):
    """K9: scatter-accumulate weighted samples. `x`, `y`, `alpha`:
    `f32[M]` (window px); `values`: `f32[C, M]`. Returns `(num f32[C, H,
    W] = sum val*a, wsum f32[H, W] = sum a, logt f32[H, W] = sum
    log(1-a))`, views of one fresh accumulator."""
    if cuda_lib.on_cpu(x, y, values, alpha):
        return splat_accumulate_plain(grid_hw, x, y, values, alpha)
    accum = _splat_points(grid_hw, x, y, values, alpha)
    c = values.shape[0]
    return accum[:c], accum[c], accum[c + 1]


def _splat_points(grid_hw, x, y, values, alpha):
    """K9's launch on CUDA tensors: the f32 `[C + 2, H, W]` accumulator."""
    h, w = grid_hw
    c, m = values.shape
    cuda_lib.check(x, "x", _F32, (m,))
    cuda_lib.check(y, "y", _F32, (m,))
    cuda_lib.check(values, "values", _F32, (c, m))
    cuda_lib.check(alpha, "alpha", _F32, (m,))
    if (c + 2) * h * w >= 2 ** 31:
        raise ValueError(f"a [{c + 2}, {h}, {w}] accumulator has 2^31 "
                         "texels or more; the kernel indexes it with 32 bits")
    dev = x.device
    key = (c, h, w, dev, _stream())
    s = _scratch(*key)
    blocks = convert_blocks(
        torch.cuda.get_device_properties(dev).multi_processor_count)
    accum = torch.empty((c + 2, h, w), dtype=_F32, device=dev)
    try:
        cuda_lib.launch("tt_splat_points", "splat_points", x, y, values,
                        alpha, c, m, h, w, s["epoch"], blocks, s["bits"],
                        s["fix"], s["marks"], accum,
                        kernels=SPLAT_POINTS_LAUNCHES if m else 1)
    except Exception:
        _kept.pop(key, None)
        raise
    return accum


def splat_accumulate_plain(grid_hw, x, y, values, alpha):
    """Plain version of K9: the kernel's deposits, each quantised at its
    channel's fixed-point step and summed in int64 (`fixed_point`), so
    that it gives the kernel's bits whatever the order of its adds. The
    step comes from each channel's largest |add| over the samples the
    kernel counts (alpha != 0, a corner in the grid): |value x alpha|,
    |alpha| and |log1p(-alpha)|, M adds a texel at most
    (`csrc/splat_points.cu`)."""
    cuda_lib.plain_calls["splat_points"] += 1
    h, w = grid_hw
    c, m = values.shape
    idx, wgt, valid = _bilinear_corners(x, y, h, w)
    aw = alpha[None, :] * wgt
    log1a = torch.log1p(-torch.clamp(alpha, max=1.0 - 1e-4))
    adds = torch.cat([values[:, None, :] * aw[None], aw[None],
                      (log1a[None, :] * wgt)[None]])  # [C + 2, 4, M]
    x0 = torch.floor(x - 0.5)
    y0 = torch.floor(y - 0.5)
    on = (alpha != 0) & (x0 >= -1) & (x0 <= w - 1) & (y0 >= -1) \
        & (y0 <= h - 1)
    mags = torch.cat([(values * alpha).abs(), alpha.abs()[None],
                      log1a.abs()[None]])  # [C + 2, M]
    bound = torch.where(on, mags, 0.0).amax(dim=1) if m else \
        torch.zeros(c + 2, dtype=_F32, device=x.device)
    s = fixed_point.fixed_shift(bound, m)
    q = torch.where(valid > 0, fixed_point.quantise(
        adds, fixed_point.pow2(s)[:, None, None]), 0)
    total = torch.zeros((c + 2, h * w), dtype=torch.int64, device=x.device)
    total.index_add_(1, idx.reshape(-1), q.reshape(c + 2, -1))
    acc = fixed_point.dequantise(total, s[:, None]).reshape(c + 2, h, w)
    return acc[:c], acc[c], acc[c + 1]
