"""Named sim configurations (`tendrils_tpu/models/configs.py`), the
reference's quality tiers and BASELINE.md's five benchmark configs:
config 1's family (`default_preview`, 256² particles; `bench.py:180-186`
runs it at 720x1280 with `flowWeight = 0`), config 2 (`one_m_flow`, the
headless main path), config 3 (`respawn_stress_4m`, 4M particles, the
caller respawning), config 4 (`optical_flow_driven`, the camera- and
pointer-driven interactive frame, `Tendrils.step_draw_io`) and config 5
(`live_show_16m`, 16.7M particles at 4K; its show frame is
`step_draw_io(bokeh=(3.0, 40.0))`). `build(name)` returns a spawned,
ready-to-step engine on `device`; `EngineConfig(merge_reorder=True)` in
place of its config turns the merge reorder on.
"""

from ..engine import EngineConfig, Tendrils
from ..spawners import spawn_ball


def _backends():
    return {"splat_backend": "kernel", "gather_backend": "kernel",
            "flow_samples": 2, "flow_rows": 1, "view_samples": 2}


def _spawned(cfg, radius=0.6, speed=0.01, device="cuda"):
    eng = Tendrils(cfg, device=device)
    eng.setup()
    spawn_ball(radius=radius, speed=speed).spawn(eng)
    return eng


def default_preview(view_res=(360, 640), device="cuda"):
    """BASELINE config 1 family: 256² particles, light preview."""
    return _spawned(EngineConfig(root_num=256, view_res=view_res,
                                 **_backends()), device=device)


def one_m_flow(view_res=(1080, 1920), device="cuda"):
    """BASELINE config 2: 1M particles, flow feedback + 1080p trail."""
    return _spawned(EngineConfig(root_num=1024, view_res=view_res,
                                 **_backends()), device=device)


def respawn_stress_4m(view_res=(1080, 1920), device="cuda"):
    """BASELINE config 3: 4M particles (respawn stress driven by the
    caller)."""
    return _spawned(EngineConfig(root_num=2048, view_res=view_res,
                                 **_backends()), device=device)


def optical_flow_driven(view_res=(720, 1280), device="cuda"):
    """BASELINE config 4: camera-flow-driven 512² sim (feed frames via
    `media.OpticalFlow` and pointer paths via `flow_line.FlowLines` to
    `step_draw_io`)."""
    return _spawned(EngineConfig(root_num=512, view_res=view_res,
                                 **_backends()), device=device)


def live_show_16m(view_res=(2160, 3840), device="cuda"):
    """BASELINE config 5 / north star: 16.7M particles, 4K trail buffer."""
    return _spawned(EngineConfig(root_num=4096, view_res=view_res,
                                 **_backends()), device=device)


def quality_tier(level, view_res=(1080, 1920), device="cuda"):
    """The reference's quality tiers — ref `demo.main.js:978-1009`:
    rootNum × {1, 2, 4} (level 0, 1, 2) with damping nudged down per
    tier."""
    from ..state import default_state
    d = default_state()
    root = d["rootNum"] * (2 ** level)
    eng = _spawned(EngineConfig(root_num=root, view_res=view_res,
                                **_backends()), device=device)
    eng.state["damping"] = d["damping"] - 1e-3 * level
    return eng


MODELS = {
    "default-preview": default_preview,
    "1m-flow": one_m_flow,
    "4m-respawn-stress": respawn_stress_4m,
    "optical-flow-driven": optical_flow_driven,
    "16m-live-show": live_show_16m,
}


def build(name, **kw):
    """Build a named model configuration."""
    return MODELS[name](**kw)
