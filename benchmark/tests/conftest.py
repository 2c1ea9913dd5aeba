"""Shared helpers of the benchmark's own tests (`python -m pytest
benchmark/tests -q` from the root). They run on the CPU at a tiny size;
the test marked `card` runs one cell on a card and skips without one."""

import copy
import pathlib
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

CELLS = ("tier1-headless", "show16m-show", "show16m-headless",
         "tier1-respawn")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips where none is visible")


def tiny(name, root_num=16, view_res=(32, 128)):
    """Cell `name` at a size the CPU runs in a moment."""
    from benchmark import cell
    c = cell.load(name)
    c.config = copy.deepcopy(c.config)
    c.config["engine"]["root_num"] = root_num
    c.config["engine"]["view_res"] = list(view_res)
    return c


@pytest.fixture
def tiny_cell():
    return tiny
