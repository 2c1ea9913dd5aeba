"""The port's CLI (`python -m tendrils_tpu_torch`, the port of
`tendrils_tpu/__main__.py`) on the CPU: its flags, the PNG frames, the
final checkpoint and the JSON line the JAX CLI prints, a resume from that
checkpoint, and `--list-presets` against the JAX CLI's list.

Tolerance: none. The files must exist with the stated shapes, the JSON
line must have the JAX CLI's keys, and the preset lists must be equal.
"""

import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

from tendrils_tpu.__main__ import main as jax_main
from tendrils_tpu_torch.__main__ import main as port_main

REPO = pathlib.Path(__file__).resolve().parents[1]
SMALL = ["--device", "cpu", "--res", "48x64", "--root", "16"]
KEYS = ["frames", "particles", "ms_per_frame", "particle_steps_per_sec",
        "out"]


def _json_line(text):
    return json.loads(text.strip().splitlines()[-1])


def _png_shape(path):
    from PIL import Image
    return np.asarray(Image.open(path)).shape


def test_list_presets_matches_jax(capsys):
    assert port_main(["--list-presets"]) == 0
    port = capsys.readouterr().out
    assert jax_main(["--list-presets"]) == 0
    assert port == capsys.readouterr().out
    assert len(port.strip().splitlines()) == 41


@pytest.mark.parametrize("preset", [None, "Pissarides"])
def test_cli_writes_frames_checkpoint_and_json(tmp_path, capsys, preset):
    """`--frames 3` (every frame written; with a preset, every 2nd):
    the PNGs of the view's size, `final.ckpt.npz` in the JAX layout, and
    the JSON line with the JAX CLI's keys."""
    out = tmp_path / "out"
    args = SMALL + ["--frames", "3", "--out", str(out)]
    every = 1
    if preset:
        every = 2
        args += ["--preset", preset, "--every", "2"]
    assert port_main(args) == 0
    line = _json_line(capsys.readouterr().out)
    assert list(line) == KEYS
    assert line["frames"] == 3 and line["particles"] == 256
    assert line["out"] == str(out) and line["ms_per_frame"] > 0
    pngs = sorted(p.name for p in out.glob("frame_*.png"))
    assert pngs == [f"frame_{i:05d}.png" for i in range(0, 3, every)]
    assert all(_png_shape(out / p) == (48, 64, 3) for p in pngs)
    ck = np.load(out / "final.ckpt.npz")
    meta = json.loads(str(ck["__meta__"]))
    assert meta["config"] == {"root_num": 16, "view_res": [48, 64],
                              "flow_res": None}
    assert ck["particles"].shape == (4, 256)
    if preset:
        assert meta["state"]["flowWidth"] == 20  # Pissarides


def test_cli_resumes_from_a_checkpoint(tmp_path, capsys):
    """`--checkpoint` loads the state before the first frame (the JAX CLI
    parses the flag but never loads it): one frame from a 3-frame run's
    checkpoint ends one fixed step after it, with its params."""
    first = tmp_path / "a"
    port_main(SMALL + ["--preset", "Flow", "--frames", "3", "--out",
                       str(first)])
    capsys.readouterr()
    ck = first / "final.ckpt.npz"
    second = tmp_path / "b"
    assert port_main(SMALL + ["--frames", "1", "--checkpoint", str(ck),
                              "--out", str(second)]) == 0
    assert _json_line(capsys.readouterr().out)["frames"] == 1
    a = json.loads(str(np.load(ck)["__meta__"]))
    b = json.loads(str(np.load(second / "final.ckpt.npz")["__meta__"]))
    assert b["timer"]["time"] == pytest.approx(a["timer"]["time"]
                                               + 1000.0 / 60.0)
    assert b["state"]["fadeColor"] == a["state"]["fadeColor"]  # Flow's


def test_module_entry_point(tmp_path):
    """`python -m tendrils_tpu_torch` as a user runs it, in a process of
    its own: exit 0 and the JSON line last."""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run(
        [sys.executable, "-m", "tendrils_tpu_torch", *SMALL, "--frames", "2",
         "--out", str(tmp_path)], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert list(_json_line(out.stdout)) == KEYS
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "final.ckpt.npz", "frame_00000.png", "frame_00001.png"]


def test_cli_runs_the_xla_backend(tmp_path, capsys, monkeypatch):
    """`--backend xla` (the JAX CLI's choice off a TPU) runs the demo on
    the generic draw: no kernel's plain version runs but the logic
    step's (K13's, once a frame: the step has no "xla" form), the frames
    and the JSON line as on the kernel backend; an unknown backend is
    refused."""
    from tendrils_tpu_torch.app import demo as demo_mod
    from tendrils_tpu_torch.ops import cuda_lib
    made = []
    cls = demo_mod.TendrilsDemo

    class Spy(cls):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    monkeypatch.setattr("tendrils_tpu_torch.app.TendrilsDemo", Spy)
    cuda_lib.reset_counts()
    out = tmp_path / "out"
    assert port_main(SMALL + ["--backend", "xla", "--preset", "Flow",
                              "--frames", "3", "--out", str(out)]) == 0
    line = _json_line(capsys.readouterr().out)
    assert list(line) == KEYS and line["frames"] == 3
    cfg = made[0].tendrils.config
    assert (cfg.splat_backend, cfg.gather_backend) == ("xla", "xla")
    assert dict(cuda_lib.plain_calls) == {"logic_step": 3}
    assert len(list(out.glob("frame_*.png"))) == 3
    assert (made[0].tendrils.sim.view[0, 3] > 0).any()
    with pytest.raises(SystemExit):
        port_main(SMALL + ["--backend", "pallas"])
