"""BENCHMARK.json and the files it names: every configuration, traffic
mix, per-layer metric and cell has a file of its own, found by name."""

import json

from benchmark import cell
from conftest import ROOT


def test_every_entry_has_its_files():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for cfg in bench["configs"]:
        assert (ROOT / cfg["file"]).is_file()
        assert cfg["file"].startswith("benchmark/configs/")
    for w in bench["workloads"]:
        c = cell.load(w["name"], bench)
        assert c.limits and c.end_to_end and c.per_layer
        assert (cell.DIR / "traffic" / f"{w['traffic']}.json").is_file()
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(cell.reader(m["name"]))
    names = [m["name"] for m in bench["end_to_end"]]
    assert "setup_s" in names


def test_entries_keep_to_the_contract_limits():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for cfg in bench["configs"]:
        assert 1 <= len(cfg["source"]) <= 200 and len(cfg["why"]) <= 200
    for w in bench["workloads"]:
        assert len(w["why"]) <= 200 and w["chips"] == 1
    cells = {w["name"] for w in bench["workloads"]}
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert set(m.get("workloads", cells)) <= cells
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25


def test_device_bound_metrics_only_in_their_cells():
    for name, tight in (("tier1-headless", False), ("show16m-show", True),
                        ("show16m-headless", True)):
        got = {m["name"] for m in cell.load(name).end_to_end}
        assert ("frame_ms.device_bound" in got) == tight
        assert ("frame_ms_p95.device_bound" in got) == tight
        assert {"frame_ms", "frame_ms_p95", "setup_s"} <= got


def test_spawn_device_ms_only_where_the_mix_respawns():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for w in bench["workloads"]:
        c = cell.load(w["name"], bench)
        got = {m["name"] for m in c.per_layer}
        for name in ("spawn_device_ms", "spawn_host_ms"):
            assert (name in got) == bool(c.traffic.get("respawn")), name


def test_the_p95_is_held_end_to_end_where_the_mix_does_not_respawn():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for w in bench["workloads"]:
        c = cell.load(w["name"], bench)
        respawns = bool(c.traffic.get("respawn"))
        assert ("frame_ms_p95" in {m["name"] for m in c.end_to_end}) \
            != respawns
        assert ("frame_ms_p95.respawn"
                in {m["name"] for m in c.per_layer}) == respawns
