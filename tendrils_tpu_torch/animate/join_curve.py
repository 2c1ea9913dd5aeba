"""Ease-curve joining — ref `src/animate/join-curve.js:6-9`.

Reflect transitions between curves: the first inner control point of the next
curve is the colinear reflection of the last control point of the previous
curve in its final point.

A copy of `tendrils_tpu/animate/join_curve.py` (pure Python; importing that
package imports JAX).
"""


def join_curve(curve, align=1):
    if not curve:
        return 0
    if len(curve) == 1:
        return curve[0]
    return (curve[-1] - curve[-2]) * align
