"""Polyline geometry — normals, miters and ribbon vertices.

The port of `tendrils_tpu/geom.py`, the reference's line-mesh builder
(`src/geom/line/index.js:29-160`, which uses the npm `polyline-normals`
algorithm): per point a unit normal and a miter length, two vertices per
point expanded along +-normal*miter*rad (`src/geom/line/expand/index.glsl`).
Host code. `polyline_normals` takes the C++ path (`native`, built from
`native/line_mesh.cpp` with g++ at first use) and keeps the JAX module's
numpy path for a host where that library cannot be built; `paths` counts
which path each call took.
"""

import collections

import numpy as np

# The native module once loaded; False where it could not be built.
_native = None
paths = collections.Counter()  # "native" / "numpy": the path of each call


def _native_module():
    global _native
    if _native is None:
        try:
            from . import native
            native.load()
            _native = native
        except OSError:
            _native = False
    return _native or None


def _unit(v, eps=1e-12):
    n = np.linalg.norm(v, axis=-1, keepdims=True)
    return v / np.maximum(n, eps)


def polyline_normals(path, closed=False):
    """Per-point (normal, miter) like npm `polyline-normals`.

    `path`: `[P, 2]` float array. Returns (normals `[P, 2]`, miters `[P]`).
    Interior points get the angle-bisector miter `1/dot(m, n)`; open ends get
    the segment normal with miter 1.
    """
    path = np.asarray(path, np.float64)
    p = path.shape[0]
    if p == 0:
        return np.zeros((0, 2), np.float32), np.zeros((0,), np.float32)
    if p == 1:
        return np.asarray([[0.0, 1.0]], np.float32), np.ones(1, np.float32)

    native = _native_module()
    if native is not None:
        paths["native"] += 1
        return native.polyline_normals(path, closed)
    paths["numpy"] += 1

    pts = np.concatenate([path[-1:], path, path[:1]]) if closed else path
    # Segment directions and normals.
    d = _unit(pts[1:] - pts[:-1])  # [S, 2]
    seg_n = np.stack([-d[:, 1], d[:, 0]], axis=-1)

    normals = np.zeros((p, 2))
    miters = np.ones(p)

    if closed:
        # seg i connects pts[i]->pts[i+1]; point j has prev seg j, next seg
        # j+1 in the padded arrays.
        for j in range(p):
            n0 = seg_n[j]
            n1 = seg_n[j + 1]
            m = _unit((n0 + n1)[None])[0]
            normals[j] = m
            miters[j] = 1.0 / max(np.dot(m, n1), 1e-6)
    else:
        normals[0] = seg_n[0]
        normals[-1] = seg_n[-1]
        for j in range(1, p - 1):
            n0 = seg_n[j - 1]
            n1 = seg_n[j]
            m = _unit((n0 + n1)[None])[0]
            normals[j] = m
            miters[j] = 1.0 / max(np.dot(m, n1), 1e-6)

    return normals.astype(np.float32), miters.astype(np.float32)


def expand(position, normal, rad, miter):
    """Push a point along its normal — ref `geom/line/expand/index.glsl`."""
    return position + normal * rad * miter


class Line:
    """Polyline -> triangle-strip vertex data — ref `geom/line/index.js`.

    Two vertices per path point with flipped miters (`index.js:150-159`);
    extra attributes are fillable via `set_attributes` like the reference's
    extensible attribute schema (`index.js:51-65`).
    """

    def __init__(self, uniforms=None, vert_num=2, path=None, closed=False):
        self.uniforms = dict({"color": [1, 1, 1, 1], "rad": 0.1},
                             **(uniforms or {}))
        self.vert_num = vert_num
        self.path = list(path or [])
        self.closed = closed
        self.attributes = {}

    def update(self, set_attributes=None):
        drawn = list(self.path)
        if self.closed and drawn:
            normals, miters = polyline_normals(np.asarray(self.path),
                                               True)
            drawn.append(drawn[0])
            normals = np.concatenate([normals, normals[:1]])
            miters = np.concatenate([miters, miters[:1]])
        else:
            normals, miters = polyline_normals(np.asarray(drawn)
                                               if drawn else
                                               np.zeros((0, 2)), False)

        p = len(drawn)
        vn = self.vert_num
        pos = np.zeros((p * vn, 2), np.float32)
        nrm = np.zeros((p * vn, 2), np.float32)
        mit = np.zeros(p * vn, np.float32)
        for j in range(p):
            for v in range(vn):
                i = j * vn + v
                pos[i] = drawn[j]
                nrm[i] = normals[j]
                # Flip odd miters — ref `index.js:157-158`.
                mit[i] = miters[j] * ((i % 2) * 2 - 1)
                if set_attributes is not None:
                    set_attributes({"point": drawn[j],
                                    "normal": normals[j],
                                    "miter": miters[j]},
                                   {"path": j, "point": j * vn, "vert": v,
                                    "data": i}, self.attributes, self)
        self.attributes.update(position=pos, normal=nrm, miter=mit)
        return self

    def vertices(self, rad=None):
        """Expanded strip vertices `[P*2, 2]` (ref vertex shader expansion)."""
        rad = self.uniforms["rad"] if rad is None else rad
        a = self.attributes
        return expand(a["position"], a["normal"], rad,
                      a["miter"][:, None])
