"""Application layer (SURVEY §2.8): the headless demo app, preset library,
keyboard performance map and the scroll-embed sequencer.

The port of `tendrils_tpu/app/`: the presets, the keyboard map and the
sequencer are copies; `TendrilsDemo` drives the port's `Tendrils` on
`device` ("cuda" by default).
"""

from .demo import TendrilsDemo, tendrils_demo
from .presets import PRESETS

__all__ = ["PRESETS", "TendrilsDemo", "tendrils_demo"]
