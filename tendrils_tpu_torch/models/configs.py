"""Named sim configurations (`tendrils_tpu/models/configs.py`) for the
port's slices: BASELINE config 2 (`one_m_flow`, the headless main path),
config 4 (`optical_flow_driven`, the camera- and pointer-driven
interactive frame, `Tendrils.step_draw_io`) and the config-1 family
preview. `build(name)` returns a spawned, ready-to-step engine on
`device`. The other configurations need frame variants still to be ported
(ROADMAP.md queue 1, items 7 and 13).
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


def optical_flow_driven(view_res=(720, 1280), device="cuda"):
    """BASELINE config 4: camera-flow-driven 512² sim (feed frames via
    `media.OpticalFlow` and pointer paths via `flow_line.FlowLines` to
    `step_draw_io`)."""
    return _spawned(EngineConfig(root_num=512, view_res=view_res,
                                 **_backends()), device=device)


MODELS = {
    "default-preview": default_preview,
    "1m-flow": one_m_flow,
    "optical-flow-driven": optical_flow_driven,
}


def build(name, **kw):
    """Build a named model configuration."""
    return MODELS[name](**kw)
