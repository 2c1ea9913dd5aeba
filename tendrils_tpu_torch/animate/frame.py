"""Keyframe literal — ref `src/animate/frame.js:2-5`.

A copy of `tendrils_tpu/animate/frame.py` (pure Python; importing that
package imports JAX).
"""


def frame(to, time=None, ease=None, call=None, *, _single=object()):
    """Build a keyframe dict `{to, time, ease, call}`.

    Like the reference, a single argument is assumed to already be a frame.
    """
    if time is None and ease is None and call is None and isinstance(to,
                                                                     dict) \
            and "time" in to:
        return to
    return {"to": to, "time": time, "ease": ease, "call": call}
