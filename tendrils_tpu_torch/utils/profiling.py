"""Tracing & profiling (the reference has none), as
`tendrils_tpu/utils/profiling.py`, on PyTorch.

Two layers:
  - `FrameProfiler`: per-pass wall timing, each section synchronised on
    exit with the device its result lies on (`sync`), keeping a ring of
    recent frames plus running totals;
  - `trace()`: a context manager around `torch.profiler` (in place of
    `jax.profiler`) that writes a Chrome trace.
"""

import contextlib
import dataclasses
import os
import tempfile
import time
from collections import defaultdict, deque

import numpy as np
import torch


def _first_tensor(x):
    """The first tensor in `x` (a tensor, or sequences, dicts and
    dataclasses of them), or None."""
    if isinstance(x, torch.Tensor):
        return x
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        x = [getattr(x, f.name) for f in dataclasses.fields(x)]
    elif isinstance(x, dict):
        x = list(x.values())
    if isinstance(x, (list, tuple)):
        for v in x:
            t = _first_tensor(v)
            if t is not None:
                return t
    return None


def sync(x):
    """Wait until the device has computed `x`: `torch.cuda.synchronize` on
    the device of its first tensor when that is a CUDA device (a CPU
    tensor is ready when its op returns). Returns `x`."""
    t = _first_tensor(x)
    if t is not None and t.is_cuda:
        torch.cuda.synchronize(t.device)
    return x


class FrameProfiler:
    def __init__(self, history=120):
        self.history = history
        self.frames = deque(maxlen=history)
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)
        self._current = None

    def begin_frame(self):
        self._current = {}
        self._t0 = time.perf_counter()
        return self

    @contextlib.contextmanager
    def section(self, name, result=None):
        """Time a named pass; pass `result` (tensors, or a structure of
        them), or set `box["result"]` in the block, to sync on exit."""
        t0 = time.perf_counter()
        box = {}
        try:
            yield box
        finally:
            out = box.get("result", result)
            if out is not None:
                sync(out)
            dt = time.perf_counter() - t0
            if self._current is not None:
                self._current[name] = self._current.get(name, 0.0) + dt
            self.totals[name] += dt
            self.counts[name] += 1

    def end_frame(self):
        if self._current is not None:
            self._current["frame"] = time.perf_counter() - self._t0
            self.frames.append(self._current)
            self._current = None
        return self

    def summary(self):
        """Mean/p50/p95 per section over the retained frames (seconds)."""
        keys = set()
        for f in self.frames:
            keys.update(f)
        out = {}
        for k in sorted(keys):
            vals = np.asarray([f[k] for f in self.frames if k in f])
            if vals.size:
                out[k] = {
                    "mean": float(vals.mean()),
                    "p50": float(np.percentile(vals, 50)),
                    "p95": float(np.percentile(vals, 95)),
                    "count": int(vals.size),
                }
        return out

    def report(self):
        lines = []
        for k, s in self.summary().items():
            lines.append(f"{k:>24}: mean {s['mean']*1e3:7.2f} ms  "
                         f"p50 {s['p50']*1e3:7.2f}  p95 {s['p95']*1e3:7.2f}")
        return "\n".join(lines)


@contextlib.contextmanager
def trace(log_dir=None):
    """`torch.profiler` trace of the block (the CPU, and the CUDA device
    where there is one), written as a Chrome trace to
    `log_dir/trace.json` (`log_dir` defaults to `tendrils_trace` in the
    temporary directory). Yields `log_dir`."""
    from torch.profiler import ProfilerActivity, profile
    if log_dir is None:
        log_dir = os.path.join(tempfile.gettempdir(), "tendrils_trace")
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield log_dir
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
