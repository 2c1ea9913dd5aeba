"""Model zoo — named, ready-to-run sim configurations."""

from .configs import (MODELS, build, default_preview, one_m_flow,
                      optical_flow_driven)

__all__ = ["MODELS", "build", "default_preview", "one_m_flow",
           "optical_flow_driven"]
