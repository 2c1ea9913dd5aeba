"""The traced stretch: `torch.profiler` over a few frames of the window,
the trace's completeness check, and the view of it that the per-layer
metrics read (`benchmark/metrics/<name>.py`).

Frozen copies, from `chip_smoke.py` at commit 88ddd4b: the names of the
host's CUDA runtime calls that ask for a device event (`RUNTIME_CALLS`,
`chip_smoke.py:241-242`), the spin kernels that open a trace
(`PAD_LAUNCHES`, `chip_smoke.py:238`, and `time_calls`'
`torch.cuda._sleep` pads, `chip_smoke.py:426-431`) and the check that a
trace holds a device event for each of those calls
(`chip_smoke.py:436-456`); the card's published memory rate
(`HBM_BYTES_PER_S`, `chip_smoke.py:231`) and `bound` (its byte term,
`chip_smoke.py:518-523`).
"""

import collections

# The host's CUDA runtime calls that ask for a device event (a kernel, a
# copy, a fill), by the names `torch.profiler` records them under.
RUNTIME_CALLS = ("cudaLaunch", "cuLaunch", "cudaMemcpy", "cudaMemset",
                 "cuMemcpy", "cuMemset")
# The calls that launch work: kernels, and a CUDA graph as one.
LAUNCH_CALLS = ("cudaLaunch", "cuLaunch", "cudaGraphLaunch", "cuGraphLaunch")
PAD_LAUNCHES = 64  # spin kernels that open a trace
PAD_KERNEL = "spin_kernel"
TRIES = 3  # traces a run takes before it gives up on the per-layer metrics
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3, NVIDIA's data sheet, 700 W
SPAN_PREFIX = "bench."  # the harness's own spans in the trace
TOP = 10  # entries of each list of the breakdown


def bound_ms(nbytes):
    """The least time (ms) the card could take to move `nbytes` once."""
    return nbytes / HBM_BYTES_PER_S * 1e3


def union_us(intervals):
    """Total length of the union of `(start, end)` intervals."""
    total = 0.0
    cur_s = cur_e = None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def gaps_us(intervals, start, end):
    """The idle gaps `(start, end)` inside `[start, end]` that no interval
    covers."""
    out = []
    t = start
    for s, e in sorted(intervals):
        if s > t:
            out.append((t, min(s, end)))
        t = max(t, e)
        if t >= end:
            break
    if t < end:
        out.append((t, end))
    return [(a, b) for a, b in out if b > a]


class TraceView:
    """What the metric readers see of a run. `frames`: frames in the traced
    stretch; `device_ops`: `(name, start_us, end_us)` of each kernel, copy
    and fill in it; `launch_calls`: the host's launch calls in it;
    `stretch`: `(start_us, end_us)`, from the host start of its first frame
    to the end of its last device operation; `spans`: host seconds a frame
    of the window's untraced frames, by name (`traffic.Feed`); `counters`:
    the program's launch counters over the stretch; `config`: the cell's
    configuration file; `power_limit`: the card's, as nvidia-smi prints it;
    `span_calls`: the harness's spans in the stretch by name (`spawn` for
    `bench.spawn`), each `[count, device_us]`, the device time that of
    the operations launched inside a span of that name and in none
    nested in it; `intervals_ms`: the times between the end events of the
    window's frames outside the traced stretch. A reader that
    finds nothing to read returns None."""

    def __init__(self, frames=0, device_ops=(), launch_calls=0,
                 stretch=None, spans=None, counters=None, config=None,
                 power_limit="not measured", gaps=(), span_calls=None,
                 intervals_ms=()):
        self.frames = frames
        self.device_ops = list(device_ops)
        self.launch_calls = launch_calls
        self.stretch = stretch
        self.spans = spans or {}
        self.counters = counters or {}
        self.config = config or {}
        self.power_limit = power_limit
        self.gaps = list(gaps)
        self.span_calls = span_calls or {}
        self.intervals_ms = list(intervals_ms)

    def busy_us(self):
        if self.stretch is None:
            return None
        s, e = self.stretch
        return union_us([(max(a, s), min(b, e)) for _, a, b in self.device_ops
                         if b > s and a < e])


def _is_span(ev):
    return ev.name.startswith(SPAN_PREFIX)


def parse(events, frames):
    """A `TraceView` (without spans, counters or config) of a profile's
    `events()` holding spin kernels and then `frames` frames, each inside
    a `bench.frame` span; None if the trace is incomplete: it must hold a
    device event for each runtime call that asked for one."""
    from torch.autograd import DeviceType
    asked = recorded = 0
    device_ops, cpu_ops, spans = [], [], []
    launched_at, launched = {}, []  # correlation id -> the call's start
    for ev in events:
        start, end = ev.time_range.start, ev.time_range.end
        if ev.device_type == DeviceType.CUDA:
            if getattr(ev, "is_user_annotation", False) or _is_span(ev):
                continue
            recorded += 1
            if PAD_KERNEL in ev.name:
                continue
            device_ops.append((ev.name, start, end))
            launched.append((getattr(ev, "id", None), end - start))
        elif ev.device_type == DeviceType.CPU:
            if _is_span(ev):
                spans.append((ev.name, start, end))
                continue
            if ev.name.startswith(RUNTIME_CALLS):
                asked += 1
                launched_at[getattr(ev, "id", None)] = start
            cpu_ops.append((ev.name, start, end))
    frame_spans = sorted((s, e) for n, s, e in spans
                         if n == SPAN_PREFIX + "frame")
    if recorded != asked or len(frame_spans) != frames or not device_ops:
        return None
    first = frame_spans[0][0]
    launch_calls = sum(1 for n, s, _ in cpu_ops
                       if s >= first and n.startswith(LAUNCH_CALLS))
    stretch = (first, max(e for _, _, e in device_ops))
    ops = [op for op in device_ops if op[2] > first]
    gaps = name_gaps(gaps_us([(s, e) for _, s, e in ops], *stretch), spans,
                     cpu_ops)
    return TraceView(frames=frames, device_ops=ops, launch_calls=launch_calls,
                     stretch=stretch, gaps=gaps,
                     span_calls=span_calls(spans, launched_at, launched))


def span_calls(spans, launched_at, launched):
    """`{name: [count, device_us]}` of the harness's spans (`bench.<name>`):
    how many there are, and the device time of the operations whose
    launching call began inside one and in no span nested in it. Each
    launch is placed once, by its start (`launched_at`, by correlation
    id); `launched`: each device operation's `(correlation id, us)`."""
    out = {}
    for name, _, _ in spans:
        out.setdefault(name[len(SPAN_PREFIX):], [0, 0.0])[0] += 1
    held = {}
    for cid, t in launched_at.items():
        span = _innermost(spans, t)
        if cid is not None and span:
            held[cid] = span[0][len(SPAN_PREFIX):]
    for cid, us in launched:
        if cid in held:
            out[held[cid]][1] += us
    return out


def _innermost(intervals, t):
    """The shortest `(name, start, end)` of `intervals` that holds time t."""
    best = None
    for name, s, e in intervals:
        if s <= t < e and (best is None or e - s < best[2] - best[1]):
            best = (name, s, e)
    return best


def name_gaps(gaps, spans, cpu_ops, top=TOP):
    """The `top` longest idle gaps, each `(name, seconds)`, named by the
    harness span and the innermost host operation the host was in as it
    began (`bench.wait`, a frame's wait for the frame two before it;
    `bench.port`, a call into the program; `bench.spawn`, a respawn
    inside it; `loop`, between spans)."""
    longest = sorted(gaps, key=lambda g: g[0] - g[1])[:top]
    out = []
    for a, b in longest:
        span = _innermost(spans, a)
        where = span[0][len(SPAN_PREFIX):] if span else "loop"
        op = _innermost(cpu_ops, a)
        out.append((f"{where}:{op[0]}" if op else where, (b - a) / 1e6))
    return out


def device_ops_by_name(view, top=TOP):
    """The `top` device operations by their time, `(name, seconds a
    frame)`."""
    acc = collections.Counter()
    for name, s, e in view.device_ops:
        acc[name[:120]] += e - s
    return [(n, us / 1e6 / view.frames) for n, us in acc.most_common(top)]
