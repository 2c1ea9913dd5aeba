"""Tracing & profiling (the reference has none), as
`tendrils_tpu/utils/profiling.py`, on PyTorch.

Three tools:
  - `span(name)`: the frame's layers (`SPANS`) named on `torch.profiler`'s
    own timeline, the clock of its device events, while a profiler
    records; a shared null context otherwise. A span never synchronises:
    its device work is what the kernels it launched did (`by_span`);
  - `FrameProfiler`: the synchronising tool: per-pass wall timing, each
    section synchronised on exit with the device its result lies on
    (`sync`), keeping a ring of recent frames plus running totals;
  - `trace()`: a context manager around `torch.profiler` (in place of
    `jax.profiler`) that writes a Chrome trace, in which the spans show
    each layer by name.
"""

import contextlib
import dataclasses
import os
import tempfile
import time
from collections import defaultdict, deque

import numpy as np
import torch

PREFIX = "tt."  # a span's name on the profiler's timeline
# The span vocabulary: each name, its layer and what `frame_profile.py`
# reads of it (`by_span`). A nested span's name extends its parent's with
# a dot, so a layer sums with its children by prefix.
SPANS = (
    "frame",      # facade: Tendrils.step/draw/step_draw/step_draw_io; root
    "params",     # facade: Tendrils.params(), the state's uploads; host sync
    "logic",      # logic step: engine.step_sim; device ms, launches
    "draw",       # draw: engine.draw_sim, force_from_aux; device ms
    "draw.sort",  # draw: the sort and its gathers (_bin_and_splat); device ms
    "draw.wait",  # draw: the merge's ok read (in the sort); host wait ms
    "draw.merge",  # draw: the merge reorder, K10 to K11 (in the sort)
    "draw.fallback",  # draw: a refused merge's flat sort (in the sort)
    "post",       # post stage: blur and bokeh (engine._frame_io); device ms
)
_NULL = contextlib.nullcontext()


def span(name):
    """The context of span `name` (one of `SPANS`): `record_function("tt."
    + name)` while a `torch.profiler` records, else one shared null
    context, so that a frame with no profiler pays one check a span."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(PREFIX + name)
    return _NULL


# The host's CUDA calls that launch device work (a graph's launch as one),
# and those that wait for the device.
LAUNCH_CALLS = ("cudaLaunch", "cuLaunch", "cudaGraphLaunch", "cuGraphLaunch")
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize", "cudaMemcpy")


@dataclasses.dataclass
class SpanTimes:
    """One span name's share of a trace (`by_span`): `host_us`, its calls'
    host time summed; `device`, the `(start_us, end_us)` of each device
    operation launched inside it and in no span nested in it; `launches`
    and `sync_us`, the launch calls and the host time of synchronising
    calls (`SYNC_CALLS`) likewise."""
    calls: int = 0
    host_us: float = 0.0
    device: list = dataclasses.field(default_factory=list)
    launches: int = 0
    sync_us: float = 0.0

    @property
    def device_us(self):
        """The union of the device intervals' lengths."""
        total, end = 0.0, None
        for s, e in sorted(self.device):
            if end is None or s > end:
                total += e - s
                end = e
            elif e > end:
                total += e - end
                end = e
        return total


def innermost(spans, times):
    """For each of `times`, the name of the innermost of the nested
    `(name, start, end)` spans that holds it, or None."""
    spans = sorted(spans, key=lambda sp: (sp[1], -sp[2]))
    out = [None] * len(times)
    stack, k = [], 0
    for i in sorted(range(len(times)), key=times.__getitem__):
        t = times[i]
        while k < len(spans) and spans[k][1] <= t:
            while stack and stack[-1][2] <= spans[k][1]:
                stack.pop()
            stack.append(spans[k])
            k += 1
        while stack and stack[-1][2] <= t:
            stack.pop()
        out[i] = stack[-1][0] if stack else None
    return out


def by_span(events):
    """A profile's `events()` by program span: `{name: SpanTimes}`, the key
    None for what no span holds. A device operation belongs to the
    innermost span that holds the host's runtime call that launched it
    (the two share the profiler's correlation id); a runtime call to the
    innermost span that holds its start."""
    from torch.autograd import DeviceType
    spans, calls, device = [], [], []
    for ev in events:
        start, end = ev.time_range.start, ev.time_range.end
        if ev.device_type == DeviceType.CPU:
            if ev.name.startswith(PREFIX):
                spans.append((ev.name, start, end))
            elif ev.name.startswith("cu"):
                calls.append((ev, start, end))
        elif not getattr(ev, "is_user_annotation", False) \
                and not ev.name.startswith(PREFIX):
            device.append((ev.id, start, end))
    out = defaultdict(SpanTimes)
    for name, s, e in spans:
        out[name].calls += 1
        out[name].host_us += e - s
    where = {}
    holders = innermost(spans, [s for _, s, _ in calls])
    for (ev, s, e), name in zip(calls, holders):
        where[ev.id] = name
        if ev.name.startswith(LAUNCH_CALLS):
            out[name].launches += 1
        elif ev.name in SYNC_CALLS:
            out[name].sync_us += e - s
    for cid, s, e in device:
        out[where.get(cid)].device.append((s, e))
    return dict(out)



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
    """Wall time of named passes a frame (`section`), each synchronised
    with the device on exit, so that a pass's time is its own host and
    device time. It adds the synchronisations a frame's path avoids: for
    where a frame's time goes without them, trace it (`trace`) and read
    its spans (`by_span`)."""

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
