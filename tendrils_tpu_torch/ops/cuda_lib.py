"""Build, load and launch the port's hand-written CUDA kernels.

The sources under `tendrils_tpu_torch/csrc/` are compiled by nvcc for Hopper
(`sm_90a`), one nvcc process per source, all started together, and linked
into ONE shared library with a plain C interface, loaded with ctypes. The
build runs at first use, into `build/tendrils_tpu_torch/` beside the
package, under a file name keyed by a hash of the sources and flags, so an
edited `.cu` never loads a stale library. Nothing here runs at import:
importing the package needs neither nvcc nor a GPU.

Each C entry launches on PyTorch's current stream and returns
`cudaGetLastError()`; `launch` raises if that is not 0. Per-kernel counters
show which path a run took: `launches[name]` counts kernel launches (the
wrappers add one per launch), `plain_calls[name]` counts calls of the plain
PyTorch versions. `events` counts what the merge reorder did on each frame
that tried it: `reorder_merged` (the merge's order kept) or
`reorder_fallback` (a guard tripped and the frame flat-sorted).
"""

import collections
import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

import torch

_CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" \
    / "tendrils_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-Xcompiler", "-fPIC",
              # Bit-exact outputs (pack.cu's words, the K6 reassembly): no
              # contracted FMAs.
              "--fmad=false")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C entry -> argument types; the last is the stream (every entry's).
_SIGNATURES = {
    "tt_pack": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P,
                _P, _P, _P, _P, _P],
    "tt_splat_plan": [_P, _I, _I, _I, _I, _I, _I, _P, _P, _I, _P, _P],
    "tt_splat_tiles": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                       _F, _I, _I, _P, _P, _I, _P, _P],
    "tt_splat_strays": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                        _F, _I, _I, _P, _P, _P],
    "tt_splat_convert": [_P, _I, _I, _I, _I, _I, _P, _P, _P],
    "tt_resolve": [_P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P],
    "tt_resolve_view": [_P, _P, _P, _I, _I, _I, _I, _P, _P],
    "tt_gather_reconstruct": [_P, _I, _I, _P, _P, _P, _P, _P, _P, _P, _I,
                              _F, _P, _P, _P, _P, _P],
    "tt_bilinear_gather": [_P, _I, _I, _I, _P, _P, _I, _P, _P, _P],
    "tt_reconstruct": [_P, _P, _P, _P, _P, _P, _I, _P, _P, _P, _P],
    "tt_gather_keyed_p1": [_P, _I, _I, _I, _P, _I, _I, _I, _F, _P, _P],
    "tt_splat_points": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P,
                        _P, _P],
    "tt_gather_keyed_q15": [_P, _I, _I, _P, _P, _I, _I, _I, _F, _P, _P],
    "tt_gather_keyed": [_P, _I, _I, _I, _P, _P, _I, _I, _I, _P, _P],
    "tt_reorder_compact": [_P, _P, _P, _I, _I, _P, _P, _P, _P],
    "tt_reorder_apply": [_P, _P, _P, _I, _P, _P, _P, _I, _P, _P, _I, _I, _P,
                         _P, _P, _P],
    "tt_logic_step": [_P, _P, _P, _P, _I, _I, *[_P] * 16, _P, _P],
}

launches = collections.Counter()
plain_calls = collections.Counter()
events = collections.Counter()
build_seconds = None  # wall time of this process's nvcc run, if it ran one
_lib = None


def reset_counts():
    launches.clear()
    plain_calls.clear()
    events.clear()


def _nvcc():
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [pathlib.Path(cuda_home) / "bin" / "nvcc"] if cuda_home \
        else []
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(pathlib.Path(on_path))
    candidates.append(pathlib.Path("/usr/local/cuda/bin/nvcc"))
    for cand in candidates:
        if cand.is_file():
            return str(cand)
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH);"
                       " the CUDA kernels are built from csrc/ at first use")


def _run_all(cmds):
    """Run the commands side by side; raise with the output of the first
    that failed, after all have ended."""
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True))
             for cmd in cmds]
    outs = [(cmd, p.communicate()[0], p.returncode) for cmd, p in procs]
    for cmd, out, rc in outs:
        if rc:
            raise RuntimeError(f"nvcc failed ({' '.join(cmd)}):\n{out}")


def _build(so, sources):
    """Compile each source to an object (in parallel), link the library,
    and move it into place under its final name."""
    nvcc = _nvcc()
    work = BUILD_DIR / f"objs.{os.getpid()}"
    work.mkdir(parents=True, exist_ok=True)
    objs = [work / f"{src.stem}.o" for src in sources]
    try:
        _run_all([[nvcc, *NVCC_FLAGS, "-I", str(_CSRC), "-c", "-o", str(obj),
                   str(src)] for src, obj in zip(sources, objs)])
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        _run_all([[nvcc, "-shared", "-o", str(tmp), *map(str, objs)]])
        os.replace(tmp, so)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def library():
    """The loaded kernel library, built first if its sources changed."""
    global _lib, build_seconds
    if _lib is not None:
        return _lib
    sources = sorted(_CSRC.glob("*.cu"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources + sorted(_CSRC.glob("*.cuh")):
        digest.update(path.name.encode())
        digest.update(path.read_bytes())
    so = BUILD_DIR / f"libtendrils_kernels-{digest.hexdigest()[:16]}.so"
    if not so.exists():
        t0 = time.perf_counter()
        _build(so, sources)
        build_seconds = time.perf_counter() - t0
    lib = ctypes.CDLL(str(so))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.tt_error_string.argtypes = [ctypes.c_int]
    lib.tt_error_string.restype = ctypes.c_char_p
    _lib = lib
    return lib


def launch(name, counter, *args, kernels=1):
    """Run C entry `name` on the current stream; count the `kernels`
    launches it makes under `counter`. Tensor arguments pass as device
    pointers, None as a null pointer."""
    lib = library()
    conv = [a.data_ptr() if isinstance(a, torch.Tensor) else a
            for a in args]
    err = getattr(lib, name)(*conv, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"{name}: CUDA error {err}: "
                           f"{lib.tt_error_string(err).decode()}")
    launches[counter] += kernels


def on_cpu(*tensors):
    """True when every tensor is on the CPU (take the plain version), False
    when all are on one CUDA device (launch the kernel); raises otherwise."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(
            f"tensors on several devices: {sorted(map(str, devices))}")
    (device,) = devices
    if device.type == "cpu":
        return True
    if device.type != "cuda":
        raise ValueError(f"no kernel for device {device}")
    return False


def check(t, name, dtype, shape):
    """Raise unless `t` is a contiguous `dtype` tensor of `shape`."""
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) \
            or not t.is_contiguous():
        raise ValueError(
            f"{name}: want contiguous {dtype} {tuple(shape)}, got "
            f"{t.dtype} {tuple(t.shape)} contiguous={t.is_contiguous()}")
