"""The plain reference against the port at a tiny size on the CPU, where
the port runs every kernel's plain version: one frame of each mix,
worked out from the program's state before it, within the limits by
far; the reference's pieces against plainer statements of the same
sums; and the reference imports nothing of the program."""

import ast
import dataclasses

import pytest
import torch

from benchmark import cell, harness, reference, traffic
from benchmark.reference import draw, logic
from conftest import CELLS, ROOT, tiny


@pytest.mark.parametrize("name", CELLS)
def test_reference_follows_the_ports_frame(name):
    c = tiny(name)
    result, numbers, _ = harness.run(c, 2 ** 31 + 5, 0.2, False, 0.0,
                                     device="cpu")
    assert result["correct"], result["checks"]
    assert result["attempted"] > 0
    assert set(c.limits) == set(numbers)
    for k, v in numbers.items():
        assert v <= c.limits[k] / 10, (k, v)


def test_frame_times_come_from_the_seed_and_the_frame():
    c = tiny("show16m-show")
    lib = harness.program_lib()
    seed = 2 ** 31 + 99
    eng = cell.make_engine(lib, c.config, seed, "cpu")
    feed = traffic.Feed(c.traffic, eng, lib)
    for i in range(5):
        feed.frame(i)
        t, dt = reference.frame_time(c.config, c.traffic, i)
        assert (eng.timer.time, eng.timer.dt) == (t, dt)


def test_the_start_is_the_ports():
    c = tiny("tier1-headless")
    eng = cell.make_engine(harness.program_lib(), c.config, 17, "cpu")
    ref = reference.start(c.config, 17, "cpu")
    for f in ("particles", "previous", "targets", "flow", "view",
              "color_map", "idx"):
        assert torch.equal(getattr(eng.sim, f), ref[f]), f


@pytest.mark.parametrize("name", CELLS)
def test_a_frame_leaves_its_input_state_as_it_was(name):
    """The window holds the state a frame starts from, not a copy: no
    frame may write into it."""
    c = tiny(name)
    lib = harness.program_lib()
    eng = cell.make_engine(lib, c.config, 3, "cpu")
    feed = traffic.Feed(c.traffic, eng, lib)
    for i in range(4):
        held = eng.sim
        copy = {k: (v.clone() if isinstance(v, torch.Tensor) else v)
                for k, v in reference.fields(held).items()}
        feed.frame(i)
        for f in dataclasses.fields(held):
            a, b = getattr(held, f.name), copy[f.name]
            if isinstance(a, torch.Tensor):
                assert torch.equal(a, b), (i, f.name)


@pytest.mark.parametrize("width", (1.0, 5.0, 8.0))
def test_box_spread_equals_each_deposit_summed(width):
    """The accumulation (samples summed at their quanta, then spread by
    the box weights) against each sample's box deposited on its own."""
    g = torch.Generator().manual_seed(1)
    ps, hp, wp = 4, 24, 28
    n = 50
    xq = torch.randint(10 * ps, (wp - 10) * ps, (n,), generator=g)
    yq = torch.randint(10 * ps, (hp - 10) * ps, (n,), generator=g)
    val = torch.rand(n, generator=g, dtype=torch.float64)
    hist = torch.zeros(hp * ps * wp * ps, dtype=torch.float64)
    hist.index_add_(0, yq * wp * ps + xq, val)
    rows = draw._spread(hist.view(hp * ps, wp * ps), ps, width / 2, 0)
    got = draw._spread(rows, ps, width / 2, 1)

    def cover(idx, c):
        lo, hi = c - width / 2, c + width / 2
        return (torch.minimum(idx + 1.0, torch.tensor(hi))
                - torch.maximum(idx, torch.tensor(lo))).clamp(0.0, 1.0)

    want = torch.zeros(hp, wp, dtype=torch.float64)
    r = torch.arange(hp, dtype=torch.float64)
    col = torch.arange(wp, dtype=torch.float64)
    for k in range(n):
        want += val[k] * cover(r, yq[k].item() / ps)[:, None] \
            * cover(col, xq[k].item() / ps)[None, :]
    assert torch.allclose(got, want, rtol=1e-12, atol=1e-12)
    assert torch.isclose(got.sum(), val.sum() * width * width)


def test_mode3_clears_the_low_position_bits():
    n = logic.G1_MAX_ROWS + 1
    pos = torch.full((2, n), 0.3)
    vel = torch.zeros(2, n)
    part, _ = logic.reassemble(pos, vel, torch.tensor(0.01))
    xi, yi = part[0].view(torch.int32), part[1].view(torch.int32)
    assert int((xi & 3).max()) == 0 and int((yi & 7).max()) == 0
    part, _ = logic.reassemble(pos[:, :8], vel[:, :8], torch.tensor(0.01))
    assert torch.equal(part[:2], pos[:, :8])


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_reference_imports_nothing_of_the_program():
    files = sorted((ROOT / "benchmark" / "reference").rglob("*.py"))
    assert len(files) == 4
    for path in files:
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top not in ("tendrils_tpu_torch", "tendrils_tpu", "jax",
                               "jaxlib", "flax"), (path, mod)
