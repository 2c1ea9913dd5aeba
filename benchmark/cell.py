"""A cell of `BENCHMARK.json` and what it is made of, found by name: its
configuration (`benchmark/configs/<name>.json`, the file the entry names),
its traffic mix (`benchmark/traffic/<name>.json`), its metrics, their
readers (`benchmark/metrics/<name>.py`) and the limits of its check
(`benchmark/limits/<cell>.json`). Nothing here names a cell.
"""

import dataclasses
import importlib.util
import json
import pathlib

from benchmark import traffic

DIR = pathlib.Path(__file__).resolve().parent
ROOT = DIR.parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list
    limits: dict


def load_bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def _in_cell(metric, name):
    return name in metric.get("workloads", [name])


def load(name, bench=None):
    """The cell `name` of `BENCHMARK.json`; raises KeyError if it has none."""
    bench = bench or load_bench()
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(it has {sorted(cells)})")
    w = cells[name]
    cfg = {c["name"]: c for c in bench["configs"]}[w["config"]]
    e2e = [m for m in bench["end_to_end"] if _in_cell(m, name)]
    moved = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if _in_cell(m, name) and m["moves"] in moved]
    return Cell(
        name=name, chips=int(w["chips"]),
        config=json.loads((ROOT / cfg["file"]).read_text()),
        traffic=traffic.load(w["traffic"]), end_to_end=e2e,
        per_layer=per_layer,
        limits=json.loads((DIR / "limits" / f"{name}.json").read_text()))


def reader(metric_name):
    """The `read` function of `benchmark/metrics/<name>.py`: an end-to-end
    metric's reads the run's `harness.Summary`, a per-layer metric's the
    traced stretch's `trace.TraceView`."""
    path = DIR / "metrics" / f"{metric_name}.py"
    spec = importlib.util.spec_from_file_location(
        f"benchmark.metrics.{metric_name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def make_engine(lib, config, seed, device):
    """An engine of `config` from the program's modules `lib`: set up, the
    configuration's state applied, then the spawn (which ticks the timer,
    at 0 before it, once), its particles' rows put in the seed's order
    (`traffic.row_order`)."""
    eng_kw = {k: tuple(v) if isinstance(v, list) else v
              for k, v in config["engine"].items()}
    eng = lib.Tendrils(lib.EngineConfig(**eng_kw), seed=seed, device=device)
    eng.timer.step = config["dt_ms"]
    eng.state.update(config["state"])
    eng.setup()
    sp = config["spawn"]
    if sp["kind"] != "ball":
        raise ValueError(f"unknown spawn: {sp['kind']}")
    lib.spawn_ball(radius=sp["radius"], speed=sp["speed"]).spawn(eng)
    order = traffic.row_order(seed, eng.sim.idx.numel(), eng.sim.idx.device)
    eng.sim = dataclasses.replace(eng.sim, **{
        f: getattr(eng.sim, f)[..., order] for f in traffic.ROW_FIELDS})
    eng.reseed_derived()
    return eng
