"""K2's and K9's fixed-point sums: the shift rule, its bounds, and an
emulation of the integer sums against the plain splats.

The CUDA splats (`csrc/splat.cu`, `csrc/splat_points.cu`) quantise each
deposit v of channel k to q = rint(v * 2^S_k) and add the q as int64, so
that the sums do not depend on the order of the adds; the grid is
f32(sum) * 2^-S_k. S_k is the largest shift with bound_k * adds * 2^S_k <=
2^FIX_BITS (`common.cuh`: `fixed_shift`), where bound_k is the most one add
of the channel can weigh (K2: `add_bound`, static; K9: reduced from the
samples on the device) and `adds` the most adds one texel receives (K2:
adds_rows x samples, adds_rows a launch parameter, the launch's n by
default and the frame's global row count on a shard of a frame split over
ranks; K9: M). The shift rule and K2's bounds run only in CUDA: below
they are transcribed into Python, with the constants, K2's bound table
and K2's shift rule read from the CUDA source. The tests hold the transcription to the worst
case of the configurations (n x samples up to 2^25), check that every
deposit of the plain splats' arithmetic lies within its bound, and emulate
the integer sums in numpy on small seeded splats: two orders of the adds
give the same bits, and the plain versions, which sum in int64 at the
same steps (`ops/fixed_point.py`), give those bits too, and again under a
permutation of their samples. That the kernels follow the rule is checked
on the card (`chip_smoke.py`: each kernel equal to its plain version, two
calls give the same bits, and a frame replays bit for bit).
"""

import math
import pathlib
import re

import numpy as np
import pytest
import torch

from tendrils_tpu_torch.ops import draw_cuda, fixed_point, splat_cuda
from tendrils_tpu_torch.ops.tile_geom import pad_dims

CSRC = pathlib.Path(draw_cuda.__file__).resolve().parents[1] / "csrc"
COMMON = (CSRC / "common.cuh").read_text()
SPLAT = (CSRC / "splat.cu").read_text()


def _constant(src, name):
    m = re.search(rf"constexpr (?:int|float) {name} = ([0-9.]+)f?;", src)
    assert m, name
    return float(m.group(1))


FIX_BITS = int(_constant(COMMON, "FIX_BITS"))
FIX_CAP = int(_constant(COMMON, "FIX_CAP"))
LOG_BOUND = _constant(SPLAT, "LOG_BOUND")
COLOR_MAX = _constant(COMMON, "COLOR_MAX")
N_CHAN = int(_constant(COMMON, "N_CHAN"))
N_FLOW = int(_constant(COMMON, "N_FLOW"))
# The configurations' largest stream: config 5's 16,777,216 segments x 2
# samples.
MAX_ADDS = 1 << 25


# --- the rule, transcribed ---------------------------------------------------

def fixed_shift(bound, adds):
    """`common.cuh: fixed_shift`: the largest S with |bound| x adds x 2^S <=
    2^FIX_BITS (frexp: |bound| x adds < 2^e), within +-FIX_CAP."""
    e = math.frexp(abs(float(np.float32(bound))) * float(adds))[1]
    return min(max(FIX_BITS - e, -FIX_CAP), FIX_CAP)


def channel_shift(speed_limit, k, adds_rows, samples):
    """`splat.cu: channel_shift`: K2's shift of global channel k for a
    frame of `adds_rows` rows x `samples` samples (`test_k2_adds_rows_
    sets_the_step` holds the transcription to the source)."""
    return fixed_shift(add_bound(speed_limit, k), adds_rows * samples)


def add_bound(speed_limit, k):
    """`splat.cu: add_bound`: the most one add of K2's channel k weighs."""
    flow = [abs(speed_limit), abs(speed_limit), 1.0, 1.0, LOG_BOUND]
    view = [COLOR_MAX] * 4 + [1.0, LOG_BOUND]
    return (flow + view)[k]


def _source_bounds(speed_limit):
    """`add_bound`'s switch in `splat.cu`, read: channel -> bound."""
    body = re.search(r"float add_bound\(.*?\{(.*?)\n\}", SPLAT, re.S).group(1)
    values = {"fabsf(scal[0])": abs(speed_limit), "1.0f": 1.0,
              "LOG_BOUND": LOG_BOUND, "COLOR_MAX": COLOR_MAX}
    out, labels = {}, []
    for line in body.splitlines():
        line = line.strip()
        if line.startswith("case "):
            labels.append(eval(line[5:-1], {"N_FLOW": N_FLOW,  # noqa: S307
                                            "N_CHAN": N_CHAN}))
        elif line == "default:":
            labels.append("default")
        elif line.startswith("return "):
            for k in labels:
                out[k] = values[line[7:-1]]
            labels = []
    default = out.pop("default")
    return [out.get(k, default) for k in range(N_CHAN)]


def quantise(v, s):
    """`common.cuh: quantise` at 2^s: rint of the exact f32 product."""
    v = np.asarray(v, np.float32) * np.float32(2.0 ** s)
    return np.rint(v).astype(np.int64)


def dequantise(total, s):
    """The conversion: f32(sum), rounded once, times 2^-s (exact)."""
    return total.astype(np.float32) * np.float32(2.0 ** -s)


def test_transcription_constants_are_the_kernels():
    """The shift's constants and K2's bound table are `csrc/`'s: K9's
    conversion and K2's share `fixed_shift`, and K2's channels have the
    bounds the transcription uses; the plain versions' (`fixed_point`,
    `draw_cuda.add_bounds`) are the same, and so is their shift."""
    assert (FIX_BITS, FIX_CAP) == (62, 126)
    assert (fixed_point.FIX_BITS, fixed_point.FIX_CAP) == (FIX_BITS, FIX_CAP)
    assert LOG_BOUND > -math.log(1e-4) and COLOR_MAX == draw_cuda.COLOR_MAX
    assert np.float32(LOG_BOUND) == np.float32(draw_cuda.LOG_BOUND)
    for sl in (0.01, 0.5, 3.0):
        assert _source_bounds(sl) == [add_bound(sl, k)
                                      for k in range(N_CHAN)]
        scal = torch.zeros(32)
        scal[0] = sl
        np.testing.assert_array_equal(
            draw_cuda.add_bounds(scal).numpy(),
            np.float32([add_bound(sl, k) for k in range(N_CHAN)]))
    for bound in (0.0, 1e-30, 1e-12, 0.01, 1.0, 9.22, 3e5, 1e30):
        for adds in (1, 480, 1 << 21, MAX_ADDS):
            got = fixed_point.fixed_shift(torch.tensor([bound]), adds)
            assert got.item() == fixed_shift(bound, adds), (bound, adds)
    s = torch.arange(-FIX_CAP, FIX_CAP + 1)
    np.testing.assert_array_equal(fixed_point.pow2(s).double().numpy(),
                                  2.0 ** s.double().numpy())
    src = (CSRC / "splat_points.cu").read_text()
    assert "fixed_shift(__int_as_float(bits[k]), m)" in src
    assert ("fixed_shift(add_bound(scal, k), (long long)adds_rows * samples)"
            in SPLAT)


@pytest.mark.parametrize("speed_limit", [1e-6, 0.01, 0.03, 1.0, 40.0])
def test_worst_case_fits_int64(speed_limit):
    """At every stream size up to 2^25 adds a texel, every channel's worst
    sum, each add at its bound and rounded up by half a step, stays
    inside int64; at 2^25 (config 5) every channel keeps >= 33 fraction
    bits at the configurations' speed limit (0.01)."""
    for adds in (1, 2, 480, 1 << 21, 1 << 23, MAX_ADDS):
        for k in range(N_CHAN):
            bound = add_bound(speed_limit, k)
            s = fixed_shift(bound, adds)
            assert bound * adds * 2.0 ** s <= 2.0 ** FIX_BITS
            assert (bound * 2.0 ** s + 0.5) * adds < 2.0 ** 63
            # One more would reach 2^FIX_BITS: the shift is the largest
            # but where bound x adds is a power of two (bounds here are far
            # from float's exponent limits).
            assert bound * adds * 2.0 ** (s + 1) >= 2.0 ** FIX_BITS
            if speed_limit == 0.01 and adds == MAX_ADDS:
                assert s >= 33, (k, s)


def test_k9_shift_bounds_its_sums():
    """K9's shift from a reduced bound: M adds of the bound fit."""
    for m in (1, 480, 2 * 512 * 512, MAX_ADDS):
        for bound in (1e-12, 0.01, 1.0, LOG_BOUND, 1e6):
            s = fixed_shift(bound, m)
            assert (np.float32(bound) * 2.0 ** s + 0.5) * m < 2.0 ** 63


# --- K2's bounds hold, and the emulated sums --------------------------------

GRID = (48, 320)
SPEED_LIMIT = 0.03


def _stream(variant, n, seed):
    """A seeded sorted-free stream of `n` segments for `variant` ("splat",
    "splat_rgba", "splat_p0_rgba"): p1 words, q15 velocity words with the
    live bit (some rows at the speed limit), p0 words (far from p1 for a
    tenth of the rows) and rgba8 words (saturated for a tenth); the draw's
    scalars (flowWidth 5, lineWidth 1, a 1x1 map of bright colours)."""
    rng = np.random.default_rng(seed)
    h, w = GRID
    pscale = draw_cuda.pos_scale_for(GRID)
    px = rng.uniform(256.0, 256.0 + w, n).astype(np.float32)
    py = rng.uniform(16.0, 16.0 + h, n).astype(np.float32)
    p1 = (np.round(py * pscale).astype(np.int32) * 32768
          + np.round(px * pscale).astype(np.int32))
    q = rng.integers(0, 32768, (2, n)).astype(np.int32)
    q[:, : n // 10] = rng.choice([0, 32767], (2, n // 10))
    live = (rng.random(n) > 0.1).astype(np.int32)
    vl = (live << 30) | (q[1] << 15) | q[0]
    scal = np.zeros(32, np.float32)
    scal[:7] = [SPEED_LIMIT, 160.0, 5.0, 1.0, 1e-6, 0.3, 0.005]
    scal[7:11] = [1.0, 1.0, 1.0, 1.0]
    scal[11:15] = [1.0, 1.0, 1.0, 1.0]
    scal[16:20] = [1.0, 1.0, 1.0, 1.0]
    scal[30:32] = [1.0, 1.0]
    kw = dict(samples=2, grid_hw=GRID, pscale=pscale)
    if variant != "splat":
        rgba = rng.integers(0, 1 << 31, n).astype(np.int64)
        rgba[: n // 10] = 0x7fffffff
        kw["rgba"] = torch.as_tensor(rgba.astype(np.int32))
    if variant == "splat_p0_rgba":
        far = rng.random(n) < 0.1
        p0x = np.where(far, rng.uniform(1.0, 256.0 + w, n),
                       px - rng.uniform(-3, 3, n)).astype(np.float32)
        p0y = np.where(far, rng.uniform(1.0, 16.0 + h, n),
                       py - rng.uniform(-3, 3, n)).astype(np.float32)
        kw["p0"] = torch.as_tensor(
            np.round(np.clip(p0y, 1, 16 + h + 1) * pscale).astype(np.int32)
            * 32768
            + np.round(np.clip(p0x, 1, 256 + w + 1) * pscale).astype(
                np.int32))
    return (torch.as_tensor(scal), torch.as_tensor(p1), torch.as_tensor(vl),
            kw)


def _k2_deposits(scal, p1, vl, kw):
    """Every deposit of K2's plain arithmetic: `(index, value)` numpy
    arrays, the flat `[N_CHAN, hp, wp]` indices and the f32 values."""
    hp, wp = pad_dims(*GRID)
    _, _, groups = draw_cuda._splat_terms(scal, p1, vl, **kw)
    index, value = zip(*draw_cuda._box_deposits(groups, hp, wp))
    return (torch.cat(index).numpy(), torch.cat(value).numpy())


VARIANTS = ["splat", "splat_rgba", "splat_p0_rgba"]


@pytest.mark.parametrize("variant", VARIANTS)
def test_k2_deposits_within_their_bounds(variant):
    """Every deposit the plain splat adds, of every channel, lies within
    its channel's `add_bound` (the streams hold rows at the speed limit,
    saturated colours and, with p0, long segments of alpha near 1)."""
    scal, p1, vl, kw = _stream(variant, 3000, 1)
    index, value = _k2_deposits(scal, p1, vl, kw)
    hp, wp = pad_dims(*GRID)
    chan = index // (hp * wp)
    for k in range(N_CHAN):
        mag = np.abs(value[chan == k]).max()
        bound = add_bound(SPEED_LIMIT, k)
        assert 0 < mag <= bound, (k, mag, bound)


def _emulate(index, value, shifts, size, order):
    """The integer sums of the deposits `(index, value)` added in `order`,
    and their conversion: `(int64[size], f32[size])`."""
    per = size // len(shifts)
    chan = index // per
    q = np.zeros(index.size, np.int64)
    for k, s in enumerate(shifts):
        q[chan == k] = quantise(value[chan == k], s)
    total = np.zeros(size, np.int64)
    np.add.at(total, index[order], q[order])
    return total, np.concatenate([
        dequantise(total[k * per:(k + 1) * per], s)
        for k, s in enumerate(shifts)])


def _equal_to_plain(got, want, c):
    """The emulated sums' conversion is the plain version's, bit for bit,
    and no channel is empty."""
    want = want.reshape(c, -1)
    assert (np.abs(want).max(axis=1) > 0).all()
    np.testing.assert_array_equal(got.reshape(c, -1), want)


@pytest.mark.parametrize("variant", VARIANTS)
def test_k2_fixed_point_sums_are_order_free(variant):
    """K2's integer sums, emulated: two orders of the adds give the same
    bits, and the converted grid is `splat_plain`'s bit for bit."""
    n = 3000
    scal, p1, vl, kw = _stream(variant, n, 2)
    index, value = _k2_deposits(scal, p1, vl, kw)
    shifts = [channel_shift(SPEED_LIMIT, k, n, kw["samples"])
              for k in range(N_CHAN)]
    hp, wp = pad_dims(*GRID)
    size = N_CHAN * hp * wp
    rng = np.random.default_rng(3)
    a = _emulate(index, value, shifts, size, np.arange(index.size))
    b = _emulate(index, value, shifts, size, rng.permutation(index.size))
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])
    want = draw_cuda.splat_plain(scal, p1, vl, **kw).numpy()
    _equal_to_plain(a[1], want, N_CHAN)


def test_k2_adds_rows_sets_the_step():
    """K2's steps come from `adds_rows` (a launch parameter: n by default,
    the frame's global row count on a shard), read from `splat.cu`: its
    `channel_shift` and every pass (the tile pass, the strays, the
    conversion) take `adds_rows`, never a launch's own n. With adds_rows
    = 2n > n each channel's step is the smaller fixed_shift(bound, 2n x
    samples): the emulated sums at those shifts are `splat_sums_plain`'s
    at `adds_rows=2n` bit for bit, converted `splat_plain`'s. And the
    sharded draw's premise: two halves of a stream, each summed at
    adds_rows = n, add up to the whole stream's int64 sums bit for bit."""
    body = re.search(r"int channel_shift\(.*?\{(.*?)\n\}", SPLAT,
                     re.S).group(1)
    assert body.split() == ["return", "fixed_shift(add_bound(scal,", "k),",
                            "(long", "long)adds_rows", "*", "samples);"]
    calls = [re.sub(r"\s+", " ", c) for c in re.findall(
        r"pow2f\(-?channel_shift\((.*?)\)\)", SPLAT, re.S)]
    assert len(calls) == 4, calls
    for c in calls:
        assert c.split(", ")[-2] in ("P.adds_rows", "adds_rows"), c
    assert "wp / TILE_W, bits, pscale, ch0, adds_rows};" in SPLAT
    assert SPLAT.count("bits, pscale, ch0, adds_rows)") == 2
    n = 3000
    scal, p1, vl, kw = _stream("splat_rgba", n, 8)
    samples = kw["samples"]
    index, value = _k2_deposits(scal, p1, vl, kw)
    hp, wp = pad_dims(*GRID)
    for k in range(N_CHAN):
        assert (channel_shift(SPEED_LIMIT, k, 2 * n, samples)
                == channel_shift(SPEED_LIMIT, k, n, samples) - 1)
    shifts = [channel_shift(SPEED_LIMIT, k, 2 * n, samples)
              for k in range(N_CHAN)]
    total, grid = _emulate(index, value, shifts, N_CHAN * hp * wp,
                           np.arange(index.size))
    sums = draw_cuda.splat_sums_plain(scal, p1, vl, adds_rows=2 * n, **kw)
    np.testing.assert_array_equal(sums.numpy().reshape(-1), total)
    _equal_to_plain(grid, draw_cuda.splat_plain(
        scal, p1, vl, adds_rows=2 * n, **kw).numpy(), N_CHAN)
    half = n // 2
    parts = [draw_cuda.splat_sums_plain(
        scal, p1[rows], vl[rows], adds_rows=n,
        **{k: v[rows] if isinstance(v, torch.Tensor) else v
           for k, v in kw.items()})
        for rows in (slice(None, half), slice(half, None))]
    whole = draw_cuda.splat_sums_plain(scal, p1, vl, **kw)
    assert torch.equal(parts[0] + parts[1], whole)
    assert not torch.equal(parts[0], whole)
    assert torch.equal(draw_cuda.convert_plain(
        scal, parts[0] + parts[1], samples=samples, adds_rows=n),
        draw_cuda.splat_plain(scal, p1, vl, **kw))


@pytest.mark.parametrize("m", [480, 20000])
def test_k9_fixed_point_sums_are_order_free(m):
    """K9's integer sums, emulated with the bounds reduced from the
    samples (|value x alpha|, |alpha|, |log1p(-alpha)|): two orders give
    the same bits, and `splat_accumulate_plain`'s bit for bit."""
    rng = np.random.default_rng(m)
    h, w = 40, 64
    x = torch.as_tensor(rng.uniform(-2, w + 2, m).astype(np.float32))
    y = torch.as_tensor(rng.uniform(-2, h + 2, m).astype(np.float32))
    vals = torch.as_tensor(rng.uniform(-0.01, 0.01, (4, m)).astype(
        np.float32))
    alpha = torch.as_tensor(rng.uniform(0, 0.999, m).astype(np.float32))
    alpha[::9] = 0.0
    idx, wgt, valid = splat_cuda._bilinear_corners(x, y, h, w)
    aw = alpha[None] * wgt
    log1a = torch.log1p(-torch.clamp(alpha, max=1.0 - 1e-4))
    value = torch.cat([vals[:, None, :] * aw[None],
                       aw[None], (log1a[None] * wgt)[None]])  # [C + 2, 4, M]
    keep = (valid > 0).expand_as(value)
    plane = h * w
    index = (torch.arange(6)[:, None, None] * plane + idx[None]).expand_as(
        value)
    index, value = index[keep].numpy(), value[keep].numpy()
    on = alpha != 0
    bounds = [(vals[k] * alpha)[on].abs().max().item() for k in range(4)]
    bounds += [alpha[on].abs().max().item(), log1a[on].abs().max().item()]
    shifts = [fixed_shift(b, m) for b in bounds]
    size = 6 * plane
    a = _emulate(index, value, shifts, size, np.arange(index.size))
    b = _emulate(index, value, shifts, size,
                 rng.permutation(index.size))
    np.testing.assert_array_equal(a[0], b[0])
    num, wsum, logt = splat_cuda.splat_accumulate_plain((h, w), x, y, vals,
                                                        alpha)
    want = torch.cat([num, wsum[None], logt[None]]).numpy()
    _equal_to_plain(a[1], want, 6)


# --- K2's view-only launch (flow_off) ----------------------------------------


def _view_launch():
    """K2's view-only launch, transcribed from `splat.cu` (each expression
    asserted in the source): `(planes, groups, view plane offset,
    step_of)`, step_of(plane) the global channel whose fixed-point step a
    scratch plane takes in each pass (tile pass, strays, conversion)."""
    ch0 = draw_cuda.first_channel(True)
    assert ch0 == N_FLOW
    assert "return ch0 == 0 ? 2 : 1;" in SPLAT  # channel_groups
    groups = 2 if ch0 == 0 else 1
    assert "(N_CHAN - ch0) * TILE_H * Q" in SPLAT  # the plan's zeroing
    assert "(long long)(N_CHAN - ch0) * plane4" in SPLAT  # the conversion
    planes = N_CHAN - ch0
    # The tile pass's view group: its planes start at N_FLOW - ch0, its
    # steps are the view's global channels N_FLOW + k.
    assert "fix + (N_FLOW - P.ch0) * (long long)P.hp * P.wp);" in SPLAT
    assert "channel_shift(P.scal, (NCH == N_FLOW ? 0 : N_FLOW) + k," in SPLAT
    # The strays: the flow group only when ch0 == 0, the view's steps
    # N_FLOW + k into the same planes.
    assert "if (P.ch0 == 0 && group_channels<N_FLOW>(P, i, g, ch))" in SPLAT
    assert "channel_shift(P.scal, N_FLOW + k, P.adds_rows, P.samples)" \
        in SPLAT
    # The conversion: scratch plane p is global channel ch0 + p.
    assert "channel_shift(scal, ch0 + (int)(i / plane4)," in SPLAT
    view_plane0 = N_FLOW - ch0
    return planes, groups, view_plane0, (
        lambda p: N_FLOW + (p - view_plane0),  # tile pass and strays
        lambda p: ch0 + p)  # conversion


@pytest.mark.parametrize("variant", VARIANTS)
def test_k2_view_only_launch_keeps_the_global_steps(variant):
    """K2's view-only launch (6 planes, one channel group): every pass
    quantises scratch plane p at the step of global channel N_FLOW + p, so
    the emulated sums, in two orders, are planes 5-10 of the 11-channel
    sums bit for bit, and the view-only `splat_plain`'s; quantised at the
    flow channels' steps (plane p at channel p), they would not be."""
    planes, groups, view_plane0, steps = _view_launch()
    assert (planes, groups, view_plane0) == (draw_cuda.N_VIEW, 1, 0)
    n = 3000
    scal, p1, vl, kw = _stream(variant, n, 4)
    adds = n * kw["samples"]
    for step_of in steps:
        assert [step_of(p) for p in range(planes)] == list(
            range(N_FLOW, N_CHAN))
    hp, wp = pad_dims(*GRID)
    _, _, groups_v = draw_cuda._splat_terms(scal, p1, vl, flow_off=True,
                                            **kw)
    assert [g[1] for g in groups_v] == [view_plane0]
    index, value = (torch.cat(a).numpy() for a in zip(
        *draw_cuda._box_deposits(groups_v, hp, wp)))
    shifts = [fixed_shift(add_bound(SPEED_LIMIT, steps[1](p)), adds)
              for p in range(planes)]
    size = planes * hp * wp
    rng = np.random.default_rng(5)
    a = _emulate(index, value, shifts, size, np.arange(index.size))
    b = _emulate(index, value, shifts, size, rng.permutation(index.size))
    np.testing.assert_array_equal(a[0], b[0])
    full_index, full_value = _k2_deposits(scal, p1, vl, kw)
    full = _emulate(full_index, full_value,
                    [fixed_shift(add_bound(SPEED_LIMIT, k), adds)
                     for k in range(N_CHAN)], N_CHAN * hp * wp,
                    np.arange(full_index.size))
    np.testing.assert_array_equal(a[0], full[0][N_FLOW * hp * wp:])
    np.testing.assert_array_equal(a[1], full[1][N_FLOW * hp * wp:])
    want = draw_cuda.splat_plain(scal, p1, vl, flow_off=True, **kw).numpy()
    _equal_to_plain(a[1], want, planes)
    wrong = _emulate(index, value,
                     [fixed_shift(add_bound(SPEED_LIMIT, p), adds)
                      for p in range(planes)], size, np.arange(index.size))
    assert not np.array_equal(wrong[0], a[0])


# --- the plain versions' sums do not depend on the order of the samples -----


@pytest.mark.parametrize("variant", VARIANTS + ["view"])
def test_k2_plain_is_order_free(variant):
    """`splat_plain` on a permutation of the stream's segments gives the
    same bits (its int64 sums), in every variant and view-only."""
    n = 3000
    scal, p1, vl, kw = _stream("splat" if variant == "view" else variant,
                               n, 6)
    perm = torch.as_tensor(np.random.default_rng(7).permutation(n))
    shuffled = {k: v[perm] if isinstance(v, torch.Tensor) else v
                for k, v in kw.items()}
    flow_off = variant == "view"
    a = draw_cuda.splat_plain(scal, p1, vl, flow_off=flow_off, **kw)
    b = draw_cuda.splat_plain(scal, p1[perm], vl[perm], flow_off=flow_off,
                              **shuffled)
    assert a.abs().sum() > 0
    assert torch.equal(a, b)


@pytest.mark.parametrize("m", [480, 20000])
def test_k9_plain_is_order_free(m):
    """`splat_accumulate_plain` on a permutation of its samples gives the
    same bits, where the f32 scatter of the xla backend
    (`splat.splat_accumulate_xla`) need not."""
    from tendrils_tpu_torch.ops import splat
    rng = np.random.default_rng(m + 1)
    h, w = 40, 64
    x = torch.as_tensor(rng.uniform(-2, w + 2, m).astype(np.float32))
    y = torch.as_tensor(rng.uniform(-2, h + 2, m).astype(np.float32))
    vals = torch.as_tensor(rng.uniform(-0.01, 0.01, (4, m)).astype(
        np.float32))
    alpha = torch.as_tensor(rng.uniform(0, 0.999, m).astype(np.float32))
    perm = torch.as_tensor(rng.permutation(m))
    a = splat_cuda.splat_accumulate_plain((h, w), x, y, vals, alpha)
    b = splat_cuda.splat_accumulate_plain((h, w), x[perm], y[perm],
                                          vals[:, perm], alpha[perm])
    for u, v in zip(a, b):
        assert u.abs().sum() > 0
        assert torch.equal(u, v)
    for u, v in zip(a, splat.splat_accumulate_xla((h, w), x, y, vals,
                                                  alpha)):
        torch.testing.assert_close(u, v, rtol=1e-5, atol=1e-6)
