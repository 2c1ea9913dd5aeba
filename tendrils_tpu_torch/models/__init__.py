"""Model zoo — named, ready-to-run sim configurations."""

from .configs import (MODELS, build, default_preview, live_show_16m,
                      one_m_flow, optical_flow_driven, quality_tier,
                      respawn_stress_4m)

__all__ = ["MODELS", "build", "default_preview", "live_show_16m",
           "one_m_flow", "optical_flow_driven", "quality_tier",
           "respawn_stress_4m"]
