"""Player — named track collection, each a Timeline. Port of
`src/animate/index.js:25-130`.

A copy of `tendrils_tpu/animate/player.py` (pure Python; importing that
package imports JAX).
"""

from .timeline import Timeline
from .tween import tween


def apply_span(span, out=None):
    """Apply a span to an output dict — ref `src/animate/index.js:13-22`:
    merge accumulated `apply`s, tween the span values in, run frame calls."""
    if out is None:
        out = {}
    if span:
        applied = span.get("apply") or {}
        if isinstance(out, list):
            for k, v in (applied.items() if isinstance(applied, dict)
                         else enumerate(applied)):
                while len(out) <= k:
                    out.append(None)
                out[k] = v
        else:
            out.update(applied)
        tween(span, out)
        for f in (span.get("call") or []):
            f(out, span)
    return out


class Player:
    def __init__(self, tracks, outputs=None):
        # tracks: dict name -> (Timeline | list of frames)
        self.tracks = {}
        self.outputs = outputs if outputs is not None else {}
        self.add(tracks)

    def add(self, tracks):
        for k, track in tracks.items():
            self.tracks[k] = (track if isinstance(track, Timeline)
                              else Timeline(track))
        return self

    def import_players(self, players):
        for player in players:
            self.add(player.tracks)
        return self

    def each(self, f):
        for k, track in self.tracks.items():
            f(track, k)
        return self

    def apply(self, f, out=None):
        """Apply `f(track, key, trackOut)`'s span into each track's output
        object — ref `animate/index.js:78-87`."""
        outputs = self.outputs if out is None else out
        for key, track in self.tracks.items():
            track_out = outputs.setdefault(key, {})
            apply_span(f(track, key, track_out), track_out)
        return self

    def seek(self, time, out=None):
        return self.apply(lambda track, *_: track.seek(time), out)

    def play(self, time, out=None):
        return self.apply(lambda track, *_: track.play(time), out)

    def play_from(self, time, start, out=None):
        return self.apply(lambda track, *_: track.play_from(time, start),
                          out)

    def frames(self):
        return {k: t.frames for k, t in self.tracks.items()}

    def start(self):
        vals = [t.start() for t in self.tracks.values()]
        return min(vals) if vals else None

    def end(self):
        # NOTE: the reference reduces `end` with Math.min as well
        # (`animate/index.js:121-124`) — preserved.
        vals = [t.end() for t in self.tracks.values()]
        return min(vals) if vals else None

    def duration(self):
        return (self.end() or 0) - (self.start() or 0)
