"""Timeline — semantic port of `src/animate/timeline.js`.

An always-time-sorted list of keyframes sandwiched between ±Infinity sentinel
frames; the playhead is a fractional `gap` between frame indices. `seek` jumps
the playhead; `play` additionally accumulates the `to`s and `call`s of any
frames skipped since the last position (`timeline.js:137-166`), so parameter
sets and side-effects fire even when the host frame rate skips over keyframes.

A copy of `tendrils_tpu/animate/timeline.py` (pure Python; importing that
package imports JAX).
"""

import math

from .frame import frame as make_frame
from .join_curve import join_curve

INF = math.inf


def order_key(f):
    return f["time"]


def offset(a, b, time):
    """Fractional position of `time` between two frames — `timeline.js:19-23`."""
    lo = min(a["time"], b["time"])
    hi = max(a["time"], b["time"])
    span = hi - lo
    if span == 0 or math.isnan(span) or math.isinf(span):
        t = 0.0
    else:
        t = (time - lo) / span
    return min(max(t, 0.0), 1.0)


def within(a, b, time):
    return min(a["time"], b["time"]) < time <= max(a["time"], b["time"])


def _accumulate(fr, out):
    """Merge a skipped frame into the span — `timeline.js:35-44`.

    List-valued `to`s (color tracks) merge as index->value entries, like JS
    `Object.assign` over an array."""
    to = fr.get("to") or {}
    if isinstance(to, (list, tuple)):
        to = dict(enumerate(to))
    out.setdefault("apply", {}).update(to)
    calls = fr.get("call")
    if calls:
        out.setdefault("call", []).extend(calls)
    return out


def _sentinel(time):
    return {"to": None, "time": time, "ease": None, "call": None}


class Timeline:
    def __init__(self, frames=None, infinite=True, rewind=False,
                 symmetric=True):
        self.infinite = infinite
        self.rewind = rewind
        # If symmetric, eases play the same forwards as backwards (the later
        # frame's ease is used); if not, the destination frame's ease is used.
        self.symmetric = symmetric
        self.frames = self.setup(frames, infinite)

        self.time = 0.0
        self.gap = -1.0
        self.span = None

    # -- keyframes: ordering and changing

    def setup(self, frames=None, infinite=True):
        frames = [make_frame(f) for f in (frames or [])]
        if infinite:
            frames = [_sentinel(-INF), *frames, _sentinel(INF)]
        self.frames = sorted(frames, key=order_key)
        return self.frames

    def merge(self, frames):
        for f in frames:
            self.add(f)
        return self

    def insert_frame(self, i, fr):
        self.frames.insert(i, fr)
        return self

    def add(self, *fr):
        adding = make_frame(*fr)
        i = self.index_of(adding)
        self.insert_frame(i, adding)
        return i

    def add_span(self, duration, *fr):
        """Adds a null frame `duration` before the added frame to pin the
        transition start — `timeline.js:108-118` (including the reference's
        return of the pre-insert index)."""
        i = self.add(*fr)
        t0 = self.frames[i]["time"] - duration
        past = self.frames[i - 1] if i > 0 else None
        if duration and (past is None or past["time"] < t0):
            self.add(None, t0)
        return i

    # -- playback

    def seek(self, time):
        """`timeline.js:124-133`."""
        if self.valid() and within(self.span["past"], self.span["next"],
                                   time):
            self.span["t"] = offset(self.span["past"], self.span["next"],
                                    time)
        else:
            self.set_time(time)
        return self.span

    def play(self, time):
        """Seek, accumulating skipped frames' `to`s and `call`s —
        `timeline.js:137-166`."""
        gap0 = max(self.gap, 0.5)
        span = self.seek(time)

        if self.valid():
            accumulated = {}
            passed = self.gap - gap0
            skipped = abs(passed)
            direction = (passed > 0) - (passed < 0)
            onwards = direction > 0  # reference `this.reverse` is never set

            if skipped > 0 and onwards:
                side = math.floor if direction < 0 else math.ceil
                f = 0
                while f < skipped:
                    idx = int(side(gap0 + f * direction))
                    if 0 <= idx < len(self.frames):
                        _accumulate(self.frames[idx], accumulated)
                    f += 1

            span = {**(span or {}), **accumulated}

        return span

    def play_from(self, time=None, start=0):
        self.seek(start)
        return self.play(self.time if time is None else time)

    def set_time(self, time):
        gap = self.gap_at(time)
        self.span = self.span_gap_at(time, gap, self.span or {})
        self.gap = gap
        self.time = time
        return self

    # -- querying

    def index_of(self, fr):
        for i, other in enumerate(self.frames):
            if order_key(other) > order_key(fr):
                return i
        return len(self.frames)

    def gap_at(self, time):
        """`timeline.js:185-195`."""
        if len(self.frames) < 2:
            return -1.0
        nxt = next((i for i, f in enumerate(self.frames)
                    if f["time"] >= time), -1)
        i = len(self.frames) - 1 if nxt < 0 else max(nxt, 1)
        return i - 0.5

    def span_gap_at(self, time, gap=None, out=None):
        """`timeline.js:197-226`."""
        if gap is None:
            gap = self.gap_at(time)
        if out is None:
            out = {}
        if gap >= 0:
            past = self.frames[math.floor(gap)]
            nxt = self.frames[math.ceil(gap)]
            ease = nxt.get("ease")
            if self.rewind:
                if not self.symmetric:
                    ease = past.get("ease")
                past, nxt = nxt, past
            out["past"] = past
            out["next"] = nxt
            out["a"] = past.get("to")
            out["b"] = nxt.get("to")
            out["t"] = offset(past, nxt, time)
            out["ease"] = ease
            return out
        return None

    # -- removing

    def splice(self, index=0, num=0, *adding):
        """Clamped between the Infinite sentinels — `timeline.js:231-250`."""
        start, remove = index, num
        if self.infinite:
            length = max(0, len(self.frames) - 2)
            i = length + index if index < 0 else index
            start = min(length, max(1, i))
            remove = min(num - max(start - i, 0), length - start)
            remove = max(remove, 0)
        removed = self.frames[start:start + remove]
        self.frames[start:start + remove] = [make_frame(a) for a in adding]
        return removed

    def splice_index(self, index, *adding):
        out = self.splice(index, 1, *adding)
        return out[0] if out else None

    def splice_at(self, time, adjacent=-1, *adding):
        gap = self.gap_at(time)
        index = int((math.ceil if adjacent > 0 else math.floor)(gap))
        out = self.splice(index, 1, *adding)
        return out[0] if out else None

    def splice_span(self, duration, start=0, *adding):
        a = self.gap_at(start)
        b = self.gap_at(start + duration)
        i = min(a, b)
        return self.splice(int(math.ceil(i)),
                           int(math.floor(max(a, b) - i)), *adding)

    # -- joining new frames to those before

    def to(self, *fr):
        self.add(*fr)
        return self

    def ease_to(self, align, *fr):
        self.ease_join(self.add(*fr), align)
        return self

    def smooth_to(self, *fr):
        return self.ease_to(1, *fr)

    def flip_to(self, *fr):
        return self.ease_to(-1, *fr)

    def over(self, duration, *fr):
        self.add_span(duration, *fr)
        return self

    def ease_over(self, duration, align, *fr):
        self.ease_join(self.add_span(duration, *fr), align)
        return self

    def smooth_over(self, duration, *fr):
        return self.ease_over(duration, 1, *fr)

    def flip_over(self, duration, *fr):
        return self.ease_over(duration, -1, *fr)

    def ease_join(self, i, align):
        """Smooth continuity with the previous frame's curve —
        `timeline.js:315-330`."""
        ease = None
        if i > 0:
            fr = self.frames[i]
            ease = list(fr.get("ease") or []) or [0, 1]
            ease.insert(1, join_curve(self.frames[i - 1].get("ease"), align))
            fr["ease"] = ease
        return ease

    # -- etc

    def valid(self, gap=None, span=None):
        gap = self.gap if gap is None else gap
        span = self.span if span is None else span
        return gap > 0 and span is not None

    def start(self):
        return self.frames[0]["time"] if self.frames else None

    def end(self):
        return self.frames[-1]["time"] if self.frames else None

    def duration(self):
        return (self.end() or 0) - (self.start() or 0)
