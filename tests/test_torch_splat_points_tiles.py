"""K9's kept scratch and tile marks (`csrc/splat_points.cu`,
`ops/splat_cuda.py`), emulated on the CPU.

The CUDA point splat keeps its int64 scratch between calls, all zero, and
marks the POINT_TILE_H x POINT_TILE_W tiles its samples' in-grid corners
reach with the call's epoch; the conversion reads and zeroes the scratch
of marked tiles only and writes 0 elsewhere. That rule runs only in CUDA,
so it is transcribed here, with its constants and its mark expressions
read from the source, and run on the wrapper's own kept state
(`splat_cuda._scratch`, allocated on the CPU): a sequence of calls on one
scratch (spread, pointer, empty, off the grid, pointer) must each give
`splat_accumulate_plain`'s grid bit for bit (both sum in int64 at the
same steps) and leave the scratch all zero, also with calls on two
streams interleaved;
the marks must cover every in-grid corner's tile, at the edges and in
partial edge tiles too. The kernels themselves are held to the same
sequence on the card (`chip_smoke.py`).
"""

import types

import pathlib
import re

import numpy as np
import pytest
import torch

from tendrils_tpu_torch.feeds import pointer_lines, trail_ms
from tendrils_tpu_torch.ops import coords, cuda_lib, flow as flow_ops
from tendrils_tpu_torch.ops import splat, splat_cuda
from tendrils_tpu_torch.state import default_state

SRC = (pathlib.Path(splat_cuda.__file__).resolve().parents[1] / "csrc"
       / "splat_points.cu").read_text()
FIX_BITS, FIX_CAP = 62, 126  # common.cuh (tests/test_torch_splat_fixed.py)


def _constant(name):
    m = re.search(rf"constexpr int {name} = ([0-9]+);", SRC)
    assert m, name
    return int(m.group(1))


TILE_H = _constant("POINT_TILE_H")
TILE_W = _constant("POINT_TILE_W")
# Partial edge tiles in both axes for the kernel's tile shape.
GRID = (9 * TILE_H + 3, 8 * TILE_W + 2)


def test_constants_and_rules_are_the_kernels():
    """The wrapper's tile shape is the kernel's, and the source marks and
    reads tiles by the rule transcribed below."""
    assert (splat_cuda.TILE_H, splat_cuda.TILE_W) == (TILE_H, TILE_W)
    flat = " ".join(SRC.split())
    assert "tiles_w = (w + POINT_TILE_W - 1) / POINT_TILE_W" in flat
    assert ("const int t = (cy / POINT_TILE_H) * tiles_w + cx / "
            "POINT_TILE_W; if (t != last && marks[t] != epoch) marks[t] = "
            "epoch;") in flat
    assert ("const int* mrow = marks + ((int)row - ch * h) / POINT_TILE_H "
            "* tiles_w;") in flat
    assert "if (__ldg(mrow + x0 / POINT_TILE_W) == epoch) {" in flat
    assert "if (__ldg(mrow + x / POINT_TILE_W) == epoch) {" in flat


@pytest.fixture
def card(monkeypatch):
    """The wrapper's launch on CPU tensors as if they lay on a card of
    `card.sms` SMs, on stream `card.stream`: `tt_splat_points`'s
    arguments and counted kernels recorded in `card.calls`."""
    fake = types.SimpleNamespace(sms=132, stream=0, calls=[])

    def launch(name, counter, *args, kernels=1):
        fake.calls.append((args, kernels))

    monkeypatch.setattr(cuda_lib, "launch", launch)
    monkeypatch.setattr(splat_cuda, "_stream", lambda: fake.stream)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda device: types.SimpleNamespace(
                            multi_processor_count=fake.sms))
    return fake


@pytest.mark.parametrize("m,want", [(0, 1), (1, 3), (480, 3), (513, 3),
                                    (5000, 3)])
def test_launches_by_samples(kept, card, m, want):
    """Three kernels a call with samples (bounds, adds and marks, the
    conversion), the conversion alone without."""
    x, y, vals, alpha = _spread(m)
    splat_cuda._splat_points(GRID, x, y, vals, alpha)
    assert card.calls[-1][1] == want
    assert splat_cuda.SPLAT_POINTS_LAUNCHES == 3


@pytest.mark.parametrize("sms", [132, 114])
def test_convert_blocks_follow_the_sms(kept, card, sms):
    """The conversion's grid is sized from the card's SM count, 8 blocks
    an SM, and passed to the kernel."""
    card.sms = sms
    splat_cuda._splat_points(GRID, *_pointer())
    (args, _), = card.calls
    assert args[9] == splat_cuda.convert_blocks(sms) == 8 * sms


def _fixed_shift(bound, adds):
    """`common.cuh: fixed_shift`."""
    e = np.frexp(abs(float(np.float32(bound))) * float(adds))[1]
    return min(max(FIX_BITS - int(e), -FIX_CAP), FIX_CAP)


def _tile_of(iy, ix, w):
    """The kernel's mark index of texel (iy, ix)."""
    return (iy // TILE_H) * (-(-w // TILE_W)) + ix // TILE_W


def _kernel(s, grid_hw, x, y, vals, alpha):
    """csrc/splat_points.cu on the kept scratch `s` (`fix`, `marks`,
    `epoch` of `splat_cuda._scratch`, this call's epoch set): the channel
    bounds of the samples with a corner in the grid, the fixed-point adds
    and marks, then the conversion that reads and zeroes the marked
    tiles. Returns the f32 `[C + 2, H, W]` grid."""
    h, w = grid_hw
    c, m = vals.shape
    fix, marks, epoch = s["fix"].numpy(), s["marks"].numpy(), s["epoch"]
    idx, wgt, valid = splat_cuda._bilinear_corners(x, y, h, w)
    a = alpha.numpy()
    valid = valid.numpy() > 0
    on = (a != 0) & valid.any(axis=0)
    # log1p as the plain version evaluates it (numpy's rounds differently
    # from torch's on a few values; the card's is CUDA's log1pf).
    log1a = torch.log1p(-torch.clamp(alpha, max=1.0 - 1e-4)).numpy()
    mags = [np.abs(vals.numpy()[k] * a) for k in range(c)]
    mags += [np.abs(a), np.abs(log1a)]
    shifts = [_fixed_shift(mg[on].max() if on.any() else 0.0, m)
              for mg in mags]
    wgt = wgt.numpy()
    idx = idx.numpy()
    for j in range(4):
        keep = on & valid[j]
        texel = idx[j][keep]
        aw = a[keep] * wgt[j][keep]
        adds = [vals.numpy()[k][keep] * aw for k in range(c)]
        adds += [aw, log1a[keep] * wgt[j][keep]]
        for k, v in enumerate(adds):
            q = np.rint(v.astype(np.float32)
                        * np.float32(2.0 ** shifts[k])).astype(np.int64)
            np.add.at(fix[k].reshape(-1), texel, q)
        marks[_tile_of(texel // w, texel % w, w)] = epoch
    iy, ix = np.divmod(np.arange(h * w), w)
    hit = (marks[_tile_of(iy, ix, w)] == epoch).reshape(h, w)
    out = np.zeros((c + 2, h, w), np.float32)
    for k in range(c + 2):
        out[k][hit] = (fix[k][hit].astype(np.float32)
                       * np.float32(2.0 ** -shifts[k]))
        fix[k][hit] = 0
    return out


def _plain(grid_hw, x, y, vals, alpha):
    num, wsum, logt = splat_cuda.splat_accumulate_plain(grid_hw, x, y, vals,
                                                        alpha)
    return torch.cat([num, wsum[None], logt[None]]).numpy()


def _equal_to_plain(got, want):
    """The emulated kernel's grid is the plain version's bit for bit: both
    sum the same deposits in int64 at the same steps."""
    np.testing.assert_array_equal(got, want)


def _pointer():
    """A pointer frame's samples on GRID, as the config-4 frame makes
    them (4 pointers, paths of the default flowDecay's 200 ms, 5 crest
    rows, 2 samples a segment)."""
    h, w = GRID
    time_, sl = 1000.0, 0.01
    lines = pointer_lines(4, time_, trail_ms(default_state()["flowDecay"]))
    p0, p1, vel, width = lines.segments(time_, coords.cover_aspect((w, h)),
                                        (h, w))
    t = torch.as_tensor
    payload = flow_ops.flow_payload(t(vel), time_, sl)
    x, y, a = splat.segment_samples(t(p0), t(p1), payload[3], 2, 1, width)
    return x, y, torch.repeat_interleave(payload, 2, dim=1), a


def _spread(m=5000, seed=4):
    rng = np.random.default_rng(seed)
    h, w = GRID
    t = torch.as_tensor
    alpha = rng.uniform(0, 0.999, m).astype(np.float32)
    alpha[::9] = 0.0
    return (t(rng.uniform(-2, w + 2, m).astype(np.float32)),
            t(rng.uniform(-2, h + 2, m).astype(np.float32)),
            t(rng.uniform(-0.01, 0.01, (4, m)).astype(np.float32)), t(alpha))


@pytest.fixture
def kept(monkeypatch):
    """The wrapper's kept-scratch table, emptied for the test."""
    monkeypatch.setattr(splat_cuda, "_kept", {})
    return splat_cuda._kept


@pytest.mark.parametrize("epoch_max", [2 ** 31 - 1, 2],
                         ids=["epochs", "wrapping"])
def test_kept_scratch_sequence(kept, monkeypatch, epoch_max):
    """Spread, pointer, empty, off the grid, pointer on one kept scratch:
    each the plain version's grid on its own input bit for bit, the
    scratch all zero after each call, the empty and
    off-grid calls all zeros, the two pointer calls equal. With the epoch
    counter wrapping every two calls, the same."""
    monkeypatch.setattr(splat_cuda, "_EPOCH_MAX", epoch_max)
    h, w = GRID
    pointer = _pointer()
    assert 0 < pointer[0].numel()
    empty = (torch.zeros(0), torch.zeros(0), torch.zeros((4, 0)),
             torch.zeros(0))
    off = (pointer[0] + 2 * w, pointer[1] - 2 * h, *pointer[2:])
    outs = []
    for inp in (_spread(), pointer, empty, off, pointer):
        s = splat_cuda._scratch(4, h, w, torch.device("cpu"), 0)
        assert 1 <= s["epoch"] <= epoch_max
        outs.append(_kernel(s, GRID, *inp))
        _equal_to_plain(outs[-1], _plain(GRID, *inp))
        assert not s["fix"].any()
    assert len(kept) == 1
    assert not outs[2].any() and not outs[3].any()
    np.testing.assert_array_equal(outs[1], outs[4])


def test_streams_keep_scratches_of_their_own(kept):
    """Calls on two streams, interleaved, each on its stream's own kept
    scratch and epochs: each the plain version's grid bit for bit, every
    scratch all zero after each call."""
    h, w = GRID
    pointer, spread = _pointer(), _spread()
    for stream, inp in ((0, spread), (1, pointer), (0, pointer),
                        (1, spread), (1, pointer)):
        s = splat_cuda._scratch(4, h, w, torch.device("cpu"), stream)
        _equal_to_plain(_kernel(s, GRID, *inp), _plain(GRID, *inp))
        assert not any(k["fix"].any() for k in kept.values())
    assert sorted(k[-1] for k in kept) == [0, 1]
    assert [k["epoch"] for k in kept.values()] == [2, 3]


def _edge_and_cluster():
    """Samples within 1 px outside every edge and corner of GRID, in its
    partial last tiles, and one further out (no corner in the grid)."""
    h, w = GRID
    xs = np.asarray([-0.9, -0.5, 0.2, 40.3, w - 1.2, w - 0.5, w + 0.4,
                     w + 0.9, w + 2.0], np.float32)
    ys = np.asarray([-0.9, -0.5, 0.2, 33.7, h - 1.2, h - 0.5, h + 0.4,
                     h + 0.9, -2.5], np.float32)
    x, y = np.meshgrid(xs, ys)
    m = x.size
    rng = np.random.default_rng(8)
    t = torch.as_tensor
    return (t(x.reshape(-1)), t(y.reshape(-1)),
            t(rng.uniform(-1, 1, (4, m)).astype(np.float32)),
            t(rng.uniform(0.1, 0.9, m).astype(np.float32)))


@pytest.mark.parametrize("case", ["edges", "pointer"])
def test_marks_cover_every_corner(kept, case):
    """Every tile holding an in-grid corner of a sample of alpha > 0 is
    marked, and no other: the tiles found from the texels by slicing the
    grid into TILE_H x TILE_W blocks (partial at the far edges) equal
    those the kernel's rule marks."""
    h, w = GRID
    x, y, vals, alpha = _edge_and_cluster() if case == "edges" \
        else _pointer()
    s = splat_cuda._scratch(4, h, w, torch.device("cpu"), 0)
    out = _kernel(s, GRID, x, y, vals, alpha)
    _equal_to_plain(out, _plain(GRID, x, y, vals, alpha))
    idx, _, valid = splat_cuda._bilinear_corners(x, y, h, w)
    live = (valid.numpy() > 0) & (alpha.numpy() != 0)
    texels = np.zeros(h * w, bool)
    texels[idx.numpy()[live]] = True
    texels = texels.reshape(h, w)
    th, tw = splat_cuda.tile_grid(h, w)
    assert (th, tw) == (10, 9)
    want = np.asarray([texels[r * TILE_H:(r + 1) * TILE_H,
                              c * TILE_W:(c + 1) * TILE_W].any()
                       for r in range(th) for c in range(tw)])
    got = s["marks"].numpy() == s["epoch"]
    np.testing.assert_array_equal(got, want)
    if case == "edges":
        # Corner tiles, partial ones included, all reached.
        assert got[0] and got[tw - 1] and got[-tw] and got[-1]


def test_a_raising_launch_drops_the_kept_scratch(kept, card, monkeypatch):
    """If the launch raises, the kept scratch is dropped, so the next call
    starts from a fresh zeroed one."""
    def refuse(*args, **kwargs):
        raise RuntimeError("tt_splat_points: CUDA error 1")

    monkeypatch.setattr(cuda_lib, "launch", refuse)
    x, y, vals, alpha = _pointer()
    with pytest.raises(RuntimeError):
        splat_cuda._splat_points(GRID, x, y, vals, alpha)
    assert kept == {}
    s = splat_cuda._scratch(4, *GRID, torch.device("cpu"), 0)
    assert s["epoch"] == 1 and not s["fix"].any() and not s["marks"].any()
