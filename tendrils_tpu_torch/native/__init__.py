"""ctypes bindings for the C++ host pieces (`native/line_mesh.cpp`).

The port of `tendrils_tpu/native/__init__.py`. `load()` builds the repo's
own `native/line_mesh.cpp` with g++ at first use, into
`build/tendrils_tpu_torch/` beside the package (never into `native/`),
under a file name keyed by a hash of the source and flags, so an edited
source never loads a stale library; nothing runs at import. It raises
OSError where g++ is missing or the build fails: every caller has a
numpy twin (`geom.polyline_normals`, `audio.analyse.log_rates`), so the
native path is an optimisation, not a requirement. This is host code:
no kernel runs here.
"""

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess

import numpy as np

_SRC = pathlib.Path(__file__).resolve().parents[2] / "native" \
    / "line_mesh.cpp"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" \
    / "tendrils_tpu_torch"
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-shared")

_lib = None


def library_path():
    """The library's file name for this source and these flags."""
    key = hashlib.sha256(_SRC.read_bytes()
                         + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libtendrils_native.{key}.so"


def _build(so):
    cxx = shutil.which("g++")
    if cxx is None:
        raise OSError("g++ not found: the native line-mesh library is "
                      "built from native/line_mesh.cpp at first use")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    out = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(_SRC)],
                         capture_output=True, text=True, timeout=120)
    if out.returncode:
        raise OSError(f"g++ failed on {_SRC}:\n{out.stderr}")
    os.replace(tmp, so)


def load():
    """The loaded library, built first if need be."""
    global _lib
    if _lib is not None:
        return _lib
    so = library_path()
    if not so.exists():
        _build(so)
    lib = ctypes.CDLL(str(so))
    lib.tendrils_polyline_normals.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.c_int64, ctypes.c_int,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float)]
    lib.tendrils_fill_ribbon.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
        ctypes.c_int64, ctypes.c_double, ctypes.c_double,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float)]
    lib.tendrils_log_rates.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.c_int64, ctypes.c_double, ctypes.POINTER(ctypes.c_float)]
    for fn in (lib.tendrils_polyline_normals, lib.tendrils_fill_ribbon,
               lib.tendrils_log_rates):
        fn.restype = None
    _lib = lib
    return lib


def _fptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _dptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def polyline_normals(path, closed=False):
    """Native twin of `geom.polyline_normals` (same contract)."""
    lib = load()
    path = np.ascontiguousarray(path, np.float64)
    n = path.shape[0]
    normals = np.empty((n, 2), np.float32)
    miters = np.empty(n, np.float32)
    lib.tendrils_polyline_normals(_dptr(path), n, int(bool(closed)),
                                  _fptr(normals), _fptr(miters))
    return normals, miters


def fill_ribbon(path, times, rad, speed):
    """Expand a timestamped path into strip vertices `[P * 2, 2]` and
    per-point velocities `[P, 2]` (the FlowLine per-frame attribute
    fill)."""
    lib = load()
    path = np.ascontiguousarray(path, np.float64)
    times = np.ascontiguousarray(times, np.float64)
    n = path.shape[0]
    verts = np.empty((n * 2, 2), np.float32)
    vels = np.empty((n, 2), np.float32)
    lib.tendrils_fill_ribbon(_dptr(path), _dptr(times), n, float(rad),
                             float(speed), _fptr(verts), _fptr(vels))
    return verts, vels


def log_rates(last, current, dt, out=None):
    """Native twin of `audio.analyse.log_rates`."""
    lib = load()
    last = np.ascontiguousarray(last, np.float32)
    current = np.ascontiguousarray(current, np.float32)
    if out is None:
        out = np.empty_like(current)
    lib.tendrils_log_rates(_fptr(last), _fptr(current), last.shape[0],
                           float(dt), _fptr(out))
    return out
