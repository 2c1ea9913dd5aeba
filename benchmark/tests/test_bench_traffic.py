"""Each cell's inputs are a function of the seed: the same seed gives the
same inputs and the same state, another seed others; the mix's own
inputs (its state values) are the same for every seed."""

import pytest
import torch

from benchmark import check, harness, reference, traffic
from conftest import CELLS, tiny


def _raw(c, seed, frames=6):
    out = [repr(traffic.state(c.traffic, i)) for i in range(frames)]
    out.append(repr(check.digest(reference.start(c.config, seed, "cpu"))))
    return out


@pytest.mark.parametrize("name", CELLS)
def test_inputs_repeat_with_the_seed_and_differ_between_seeds(name):
    c = tiny(name)
    big = 2 ** 31 + 77  # seeds may pass 32 signed bits
    a, b = _raw(c, big), _raw(c, big + 1)
    assert a == _raw(c, big)
    assert a[:-1] == b[:-1] and a[-1] != b[-1]


def _states(c, seed):
    """The state at the spawn and after the mix's warm frames."""
    from benchmark import cell
    lib = harness.program_lib()
    eng = cell.make_engine(lib, c.config, seed, "cpu")
    spawned = reference.fields(eng.sim)
    feed = traffic.Feed(c.traffic, eng, lib)
    for i in range(c.traffic["warm_frames"]):
        feed.frame(i)
    return spawned, reference.fields(eng.sim)


def _by_id(state, f):
    return check.by_identity(state[f], state["idx"])


@pytest.mark.parametrize("name", CELLS)
def test_two_seeds_run_one_set_of_particles_in_two_orders(name):
    """Two seeds spawn the same particles in two row orders, and their
    states after the warm frames agree particle by particle: the seed
    changes the order, not the work."""
    c = tiny(name)
    (a0, a), (a20, a2), (b0, b) = (_states(c, s) for s in (11, 11, 12))
    for f in ("particles", "idx"):
        assert torch.equal(a0[f], a20[f])
        assert not torch.equal(a0[f], b0[f])
    for f in ("particles", "previous", "targets"):
        assert torch.equal(_by_id(a0, f), _by_id(b0, f)), f
        assert torch.equal(_by_id(a, f), _by_id(a2, f)), f
        assert torch.equal(_by_id(a, f), _by_id(b, f)), f
    for f in ("flow", "view"):
        assert torch.equal(a[f], a2[f]) and torch.equal(a[f], b[f]), f
