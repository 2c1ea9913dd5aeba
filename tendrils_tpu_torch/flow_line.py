"""Pointer → flow-field injection (SURVEY §2.3).

A copy of `tendrils_tpu/flow_line.py` (numpy only; importing that package
imports JAX). The segments it returns feed `Tendrils.inject_flow_segments`
or `Tendrils.step_draw_io(segments=...)`.

Port of `src/flow-line/index.js` + `multi.js`: a timestamped pointer path is
painted into the flow grid as a velocity ribbon. Per path segment the painted
velocity is `(position - previous) * speed / max(dt, 1)`
(`flow-line/index.vert:28-31`), in the standard flow-payload format, with
ribbon width `rad · payload_weight` (the vertex expansion) — realised here by
the engine's segment splat with perpendicular rows instead of a rasterised
triangle strip. The fragment crest shaping (`flow-line/index.frag:10-17`,
velocity bending toward the ribbon edge normal) is approximated by the
splat's row falloff; documented deviation.
"""

import numpy as np


class FlowLine:
    def __init__(self, uniforms=None, times=None):
        self.uniforms = dict({
            "speed": 3.0, "speedLimit": 0.01, "rad": 0.1, "crestShape": 0.6,
        }, **(uniforms or {}))
        self.times = list(times or [])
        self.path = []

    # -- path editing (ref flow-line/index.js:70-96)

    def add(self, time, point):
        self.times.append(time)
        self.path.append(tuple(point))
        return self

    def insert(self, time, point):
        i = self.find_index(time)
        self.times.insert(i, time)
        self.path.insert(i, tuple(point))
        return self

    def at(self, index):
        return {"time": self.times[index], "point": self.path[index]}

    def find_index(self, time):
        for i, other in enumerate(self.times):
            if other > time:
                return i
        return len(self.times)

    def trim(self, ago, now):
        """Drop path segments older than `ago` — ref
        `flow-line/index.js:99-113`."""
        oldest = now - ago
        while self.times and self.times[0] < oldest:
            self.times.pop(0)
            self.path.pop(0)
        return len(self)

    def __len__(self):
        return len(self.times)

    # -- painting

    def flow_segments(self, time, view_size, flow_res, crest_rows=5):
        """Segments + velocity payload to splat into the flow grid.

        Returns `(p0_pix [S,2], p1_pix [S,2], vel [2,S], width_px)`.
        Velocities are `(pos - prev) * speed / max(dt, 1)` like
        `flow-line/index.vert:28-31`. The ribbon's crest shaping
        (`flow-line/index.frag:10-17`: away from the centreline, speed falls
        off `(1-d)`, the direction bends toward the crest normal by
        `d·crestShape`, and alpha drops `-d`) is realised by expanding each
        path segment into `crest_rows` parallel sub-segments with the
        per-row payload transform (host-side; pointer paths are tiny).
        """
        h, w = flow_res
        if len(self.path) < 2:
            z = np.zeros((0, 2), np.float32)
            return z, z, np.zeros((2, 0), np.float32), 0.0
        pts = np.asarray(self.path, np.float32)
        ts = np.asarray(self.times, np.float32)
        prev = pts[:-1]
        cur = pts[1:]
        dt = np.maximum(ts[1:] - ts[:-1], 1.0)
        vel = (cur - prev) * self.uniforms["speed"] / dt[:, None]  # [S, 2]

        vs = np.asarray(view_size, np.float32)

        def to_pix(p):
            clip = p * vs
            return np.stack([(clip[:, 0] * 0.5 + 0.5) * w,
                             (clip[:, 1] * 0.5 + 0.5) * h], axis=-1)

        p0 = to_pix(prev)
        p1 = to_pix(cur)

        # Ribbon width: the vertex expansion is rad * payload weight
        # (`flow-line/index.vert:35`); use the full extent.
        rad_px = self.uniforms["rad"] * 0.5 * min(h, w)
        rows = max(1, int(crest_rows))
        if rows == 1:
            return p0, p1, vel.T.astype(np.float32), float(rad_px)

        # Per-row crest transform across the ribbon, d in (-1, 1).
        d_seg = p1 - p0
        seg_len = np.maximum(np.linalg.norm(d_seg, axis=-1, keepdims=True),
                             1e-6)
        normal = np.stack([-d_seg[:, 1], d_seg[:, 0]], axis=-1) / seg_len
        crest_shape = self.uniforms["crestShape"]
        speed = np.linalg.norm(vel, axis=-1, keepdims=True)
        vel_dir = vel / np.maximum(speed, 1e-12)

        p0s, p1s, vels = [], [], []
        for r in range(rows):
            d = (r - (rows - 1) / 2.0) / max((rows - 1) / 2.0, 1.0) * 0.999
            off = normal * (d * rad_px)
            # crest dir = ribbon normal on this side (vert `crest` varying).
            crest_dir = normal * np.sign(d) if d != 0 else vel_dir
            mixed = vel_dir + (crest_dir - vel_dir) * (abs(d) * crest_shape)
            mixed /= np.maximum(np.linalg.norm(mixed, axis=-1,
                                               keepdims=True), 1e-12)
            row_vel = mixed * speed * (1.0 - abs(d))
            p0s.append(p0 + off)
            p1s.append(p1 + off)
            vels.append(row_vel)
        return (np.concatenate(p0s).astype(np.float32),
                np.concatenate(p1s).astype(np.float32),
                np.concatenate(vels).T.astype(np.float32),
                float(max(rad_px / rows, 1.0)))


class FlowLines:
    """Map of pointer-id → FlowLine, lazily created — ref
    `src/flow-line/multi.js:8-26`."""

    def __init__(self, **options):
        self.options = options
        self.active = {}

    def get(self, pointer_id):
        line = self.active.get(pointer_id)
        if line is None:
            line = self.active[pointer_id] = FlowLine(**self.options)
        return line

    def trim(self, ago, now):
        remaining = 0
        for pid in list(self.active):
            if self.active[pid].trim(ago, now) == 0:
                del self.active[pid]
            else:
                remaining += 1
        return remaining

    def segments(self, time, view_size, flow_res):
        """All live lines' segments, concatenated for one splat call."""
        p0s, p1s, vels, width = [], [], [], 0.0
        for line in self.active.values():
            p0, p1, vel, w = line.flow_segments(time, view_size, flow_res)
            if p0.shape[0]:
                p0s.append(p0)
                p1s.append(p1)
                vels.append(vel)
                width = max(width, w)
        if not p0s:
            z = np.zeros((0, 2), np.float32)
            return z, z, np.zeros((2, 0), np.float32), 0.0
        return (np.concatenate(p0s), np.concatenate(p1s),
                np.concatenate(vels, axis=1), width)
