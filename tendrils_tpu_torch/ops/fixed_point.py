"""The splats' int64 fixed-point sums (`csrc/common.cuh`), in PyTorch.

K2 and K9 add each deposit v of channel k as q = rint(v * 2^S_k) into an
int64 sum and convert the sum back as f32(sum) * 2^-S_k, rounded once:
integer adds are associative, so the grid does not depend on the order
of the adds. S_k is the largest shift with bound_k * adds * 2^S_k <=
2^FIX_BITS (`fixed_shift`), bound_k the most one add of the channel can
weigh and `adds` the most adds one texel can receive, so no sum leaves
int64. The plain versions of K2 and K9 (`draw_cuda.splat_plain`,
`splat_cuda.splat_accumulate_plain`) sum with these functions, on the
device of their inputs and without reading a device value back.
"""

import torch

FIX_BITS = 62
# |S| stays within f32's normal exponents, so 2^S and 2^-S are exact.
FIX_CAP = 126


def fixed_shift(bound, adds):
    """S of each channel, `i32[...]`: the largest shift with |bound| x adds
    x 2^S <= 2^FIX_BITS (frexp of the exact double product: |bound| x adds
    < 2^e), within +-FIX_CAP. `bound`: `f32[...]`; `adds`: an int."""
    _, e = torch.frexp(bound.abs().double() * float(adds))
    return torch.clamp(FIX_BITS - e, -FIX_CAP, FIX_CAP).to(torch.int32)


def pow2(s):
    """2^s as `f32`, exactly, for |s| <= FIX_CAP (its exponent bits)."""
    return ((s.to(torch.int32) + 127) << 23).view(torch.float32)


def quantise(v, scale):
    """rint(v * scale) as int64 (half to even, as `__float2ll_rn`);
    `scale` a power of two, so the product is exact and only the rounding
    quantises."""
    return torch.round(v * scale).to(torch.int64)


def dequantise(total, s):
    """The conversion: f32(total), rounded once, times 2^-s (exact)."""
    return total.to(torch.float32) * pow2(-s)
