"""Keyframe animation engine (SURVEY §2.5) — control plane, pure Python.

Semantic port of the reference's `src/animate/` package: `Timeline`
(always-time-sorted keyframes with ±Infinity sentinels, playhead as a
fractional gap), `Player` (named track collection), `tween` (lerp with bezier
easing over numbers or dicts of numbers), keyframe literals and smooth-ease
joins. Drives the engine's traced parameters each frame, so animation never
touches compilation.

A copy of `tendrils_tpu/animate/__init__.py` (pure Python; importing that
package imports JAX).
"""

from .frame import frame
from .join_curve import join_curve
from .player import Player, apply_span
from .timeline import Timeline, offset, order_key, within
from .tween import bezier_ease, tween, tween_props, tween_value

__all__ = [
    "Player", "Timeline", "apply_span", "bezier_ease", "frame", "join_curve",
    "offset", "order_key", "tween", "tween_props", "tween_value", "within",
]
