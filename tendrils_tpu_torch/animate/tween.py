"""Tweening — ref `src/animate/tween.js`.

Lerp with bezier easing over numbers or dicts of numbers. The ease curves are
arbitrary-length control-point lists evaluated by de Casteljau (the npm
`bezier` package the reference uses).

A copy of `tendrils_tpu/animate/tween.py` (pure Python; importing that
package imports JAX).
"""

import numbers


def _is_num(v):
    return isinstance(v, numbers.Number) and not isinstance(v, bool)


def bezier_ease(points, t):
    """De Casteljau over an arbitrary control-point list (npm `bezier`)."""
    pts = list(points)
    n = len(pts)
    if n == 0:
        return t
    if n == 1:
        return pts[0]
    while len(pts) > 1:
        pts = [a + (b - a) * t for a, b in zip(pts[:-1], pts[1:])]
    return pts[0]


def tween_value(a, b, t, ease=None):
    """Ref `src/animate/tween.js:19-21`: lerp, eased if a curve is given."""
    if a == b or not _is_num(a):
        return b
    tt = bezier_ease(ease, t) if ease else t
    return a + (b - a) * tt


def _get(container, k):
    if container is None:
        return None
    if isinstance(container, dict):
        return container.get(k)
    try:
        return container[k]
    except (IndexError, KeyError, TypeError):
        return None


def _set(container, k, v):
    if isinstance(container, dict):
        container[k] = v
    else:
        while len(container) <= k:
            container.append(None)
        container[k] = v


def _keys(container):
    if isinstance(container, dict):
        return list(container.keys())
    return list(range(len(container)))


def _tweenable(k, values, defaults):
    v = _get(values, k)
    if _is_num(v):
        return v
    return _get(defaults, k)


def tween_props(a, b, t, ease=None, out=None):
    """Ref `src/animate/tween.js:27-38`: map number props of two dicts (or
    sequences — the reference animates color arrays) into tweened numbers in
    `out` (non-numbers snap at t=1)."""
    if out is None:
        out = {} if not isinstance(b, (list, tuple)) else []
    if not b:
        return out
    for k in _keys(b):
        va = _tweenable(k, a, out)
        vb = _tweenable(k, b, out)
        if _is_num(va) and _is_num(vb):
            _set(out, k, tween_value(va, vb, t, ease))
        else:
            _set(out, k, va if t < 1 else vb)
    return out


def tween(a, b=None, t=None, ease=None, out=None):
    """Generic wrapper — ref `src/animate/tween.js:46-49`.

    Either `tween(a, b, t, ease)` with numbers/dicts, or `tween(span, out)`
    where `span` is a dict of named args `{a, b, t, ease}`.
    """
    if isinstance(a, dict) and "t" in a and ("a" in a or "b" in a):
        span, out = a, (b if b is not None else out)
        return tween(span.get("a"), span.get("b"), span.get("t"),
                     span.get("ease"), out)
    if _is_num(b):
        return tween_value(a, b, t, ease)
    return tween_props(a, b, t, ease, out if out is not None else {})
