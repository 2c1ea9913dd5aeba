"""Timer — wall-clock or fixed-step time with rate/pause/seek/loop.

Semantic port of the reference's `src/timer.js` (all times in milliseconds,
like the reference — `step: 1000/60` is the engine default, `src/index.js:67`).
Pure host-side control plane; `time`/`dt` are fed into the frame as f32
scalars. A copy of `tendrils_tpu/timer.py` (importing that package imports
JAX).
"""

import time as _time


def _now_ms():
    return _time.time() * 1000.0


class Timer:
    def __init__(self, now=None, since=None):
        self.time = 0.0
        self.since = 0.0
        self.offset = 0.0
        self.rate = 1.0
        self.step = -1.0
        self.dt = 0.0
        self.paused = False
        self.end = -1.0
        self.loop = False
        self.reset(now, since)

    def now(self, now=None):
        """Ref `src/timer.js:20-22`."""
        if now is None:
            now = _now_ms()
        return (now - self.offset) * self.rate

    def tick(self, now=None):
        """Advance — ref `src/timer.js:24-60`.

        Fixed-step when `step >= 0` (deterministic replay mode), wall-clock
        otherwise. Honours pause (time holds, offset slides), `end` and
        `loop`.
        """
        time = self.time
        if self.step >= 0:
            dt = self.step * self.rate
            time += dt
        else:
            past = time
            time = self.now(now)
            dt = time - past

        if self.paused:
            self.offset += dt
            dt = 0.0
        elif self.end < 0:
            self.time = time
        elif self.loop:
            self.time = time % self.end
        else:
            clamped = min(time, self.end) if self.rate > 0 else max(time,
                                                                    self.end)
            self.time = clamped
            if self.time != time:
                self.paused = True

        self.dt = dt
        return self

    def seek(self, to):
        self.offset = -to
        return self

    def scrub(self, by):
        self.offset -= by
        return self

    def reset(self, now=None, since=None):
        if now is None:
            now = _now_ms()
        if since is None:
            since = now
        self.since = self.offset = since
        self.time = self.now(now)
        return self
