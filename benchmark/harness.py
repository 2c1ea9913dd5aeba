"""One run of one cell: set-up, the measured window, the traced stretch
(`--trace 1`) and the check against the plain reference.

The window is a closed loop, as a display's swap chain is: frame i starts
once frame i - 2's end event has completed, so at most two frames are in
flight; a CUDA event is recorded after each frame and nothing else waits
on the device. It runs from the first frame's start until the host clock
passes `seconds`, and ends with a synchronize.

  frame_ms      the window's wall time over its frames;
  frame_ms_p95  the 95th percentile (nearest rank) over all the window's
                frames of the time between consecutive end events (the
                first from an event recorded as the window opens);
  peak_mem_gib  `torch.cuda.max_memory_allocated()` over set-up and
                window;
  setup_s       from the process's start (`t0`) to the window's start:
                imports, the kernels' build or load, the engine's set-up
                and spawn on the device, the mix's warm frames.

Every metric, end-to-end or per-layer, is read by its own file,
`benchmark/metrics/<name>.py`: an end-to-end reader from the run's
`Summary`, a per-layer one from the traced stretch's `trace.TraceView`.

With `--trace 1` the loop profiles `PROFILED` frames once half the window
has passed (a synchronize, spin kernels, the frames, a synchronize), and
the per-layer metrics read that stretch and the window's other frames.

In a mix that respawns the particles, the run goes on after the window,
untimed and once the peak is read, up to and including the mix's next
respawn frame, which the check follows too (`run_to_respawn`).
"""

import collections
import contextlib
import dataclasses
import gc
import math
import resource
import subprocess
import sys
import time
import types

import torch

from benchmark import cell as cell_mod, check, trace, traffic
from benchmark import reference

PROFILED = 10  # frames in the traced stretch


def program_lib():
    """The program's modules that a run drives."""
    import tendrils_tpu_torch as tt
    from tendrils_tpu_torch.spawners import spawn_ball
    return types.SimpleNamespace(Tendrils=tt.Tendrils,
                                 EngineConfig=tt.EngineConfig,
                                 spawn_ball=spawn_ball)


def p95(values):
    """The 95th percentile by nearest rank: the value that 95 % of
    `values` are at or below."""
    v = sorted(values)
    return v[max(0, math.ceil(0.95 * len(v)) - 1)]


@dataclasses.dataclass
class Summary:
    """What the end-to-end readers read: the window's wall time over its
    frames, the intervals between its frames' end events, the allocator's
    peak and the set-up's seconds."""
    frame_ms: float
    intervals_ms: list
    peak_bytes: int
    setup_s: float


class Clock:
    """End marks of frames: CUDA events on a card, the host clock on the
    CPU (where every operation has ended when it returns)."""

    def __init__(self, device):
        self.cuda = device.type == "cuda"

    def mark(self):
        if not self.cuda:
            return time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def wait(self, m):
        if self.cuda:
            m.synchronize()

    def sync(self):
        if self.cuda:
            torch.cuda.synchronize()

    def ms(self, a, b):
        return a.elapsed_time(b) if self.cuda else (b - a) * 1e3


@dataclasses.dataclass
class Window:
    frames: int = 0
    seconds: float = 0.0
    intervals_ms: list = dataclasses.field(default_factory=list)
    spans: dict = dataclasses.field(
        default_factory=lambda: collections.defaultdict(list))
    view: object = None
    traces: int = 0
    last_in: object = None  # the program's state before the last frame
    last_i: int = -1
    screen: object = None
    # The intervals that span a traced stretch, one a try.
    stretches: list = dataclasses.field(default_factory=list)


def _span(name):
    return torch.profiler.record_function(trace.SPAN_PREFIX + name)


def run_window(feed, eng, first, seconds, clock, want_trace, counters):
    """The measured window from frame `first` on; see the module."""
    w = Window()
    marks = [clock.mark()]
    t_start = time.perf_counter()
    i = first
    while True:
        elapsed = time.perf_counter() - t_start
        if elapsed >= seconds:
            break
        if (want_trace and w.view is None and w.traces < trace.TRIES
                and elapsed >= seconds / 2):
            w.view = _traced_stretch(feed, eng, i, clock, w, counters)
            i += PROFILED
            w.frames += PROFILED
            marks.append(clock.mark())
            w.stretches.append(len(marks) - 2)
            continue
        if len(marks) >= 3:
            clock.wait(marks[-2])
        w.last_in, w.last_i, w.screen = eng.sim, i, None
        w.screen = feed.frame(i, spans=w.spans)
        marks.append(clock.mark())
        w.frames += 1
        i += 1
    clock.sync()
    w.seconds = time.perf_counter() - t_start
    w.intervals_ms = [clock.ms(a, b) for a, b in zip(marks, marks[1:])]
    return w


def _traced_stretch(feed, eng, i, clock, w, counters):
    """`PROFILED` frames under `torch.profiler`; the `TraceView`, or None
    if its trace fails the completeness check."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if clock.cuda:
        acts.append(ProfilerActivity.CUDA)
    pads = trace.PAD_LAUNCHES << w.traces
    w.traces += 1
    clock.sync()
    before = collections.Counter(counters)
    feed.mark = _span
    try:
        with profile(activities=acts) as prof:
            if clock.cuda:
                for _ in range(pads):
                    torch.cuda._sleep(1)
            clock.sync()
            marks = []
            for k in range(PROFILED):
                if len(marks) >= 2:
                    with _span("wait"):
                        clock.wait(marks[-2])
                with _span("frame"):
                    w.last_in, w.last_i, w.screen = eng.sim, i + k, None
                    w.screen = feed.frame(i + k)
                marks.append(clock.mark())
            clock.sync()
    finally:
        feed.mark = lambda name: contextlib.nullcontext()
    view = trace.parse(prof.events(), PROFILED) if clock.cuda else None
    if view is not None:
        view.counters = dict(collections.Counter(counters) - before)
    return view


def run_to_respawn(feed, eng, last, clock):
    """The mix's frames from `last + 1` on, untimed, up to and including
    its next respawn frame `i`: `(i, the state before it, the state the
    respawn left, the state after it, its screen)`, each `{field:
    tensor}`."""
    i = last + 1
    while not traffic.respawns(feed.spec, i):
        feed.frame(i)
        i += 1
    before = eng.sim
    feed.keep_spawned = True
    screen = feed.frame(i)
    clock.sync()
    return (i, reference.fields(before), reference.fields(feed.spawned),
            reference.fields(eng.sim), screen)


def nvidia_smi():
    """The card's name, power limit and clocks as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,power.draw,"
             "clocks.sm,clocks.max.sm,clocks.mem,temperature.gpu",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"not measured ({e})"


def _power_limit(smi):
    parts = [p.strip() for p in smi.split(",")]
    return parts[1] if len(parts) > 1 else "not measured"


def _host_usage():
    """The process's CPU seconds and garbage collections so far, to read
    beside the window's wall time."""
    ru = resource.getrusage(resource.RUSAGE_SELF)
    return {"cpu_s": ru.ru_utime + ru.ru_stime,
            "gc_collections": sum(g["collections"] for g in gc.get_stats())}


def log(msg):
    print(f"bench: {msg}", file=sys.stderr, flush=True)


def run(c, seed, seconds, want_trace, t0, device="cuda", controls=(),
        lib=None):
    """One run of cell `c` (`cell.Cell`); returns `(result, numbers,
    control_numbers)`: the result line's object, the compared numbers,
    and `{control: numbers}` of each control in `controls` (a `lowp` of
    `reference`) put in the program's place."""
    device = torch.device(device)
    lib = lib or program_lib()
    from tendrils_tpu_torch.ops import cuda_lib
    clock = Clock(device)
    if clock.cuda:
        torch.cuda.reset_peak_memory_stats()
    t_enter = time.perf_counter()
    eng = cell_mod.make_engine(lib, c.config, seed, device)
    start_digest = check.digest(reference.fields(eng.sim))
    t_engine = time.perf_counter()
    feed = traffic.Feed(c.traffic, eng, lib)
    warm = int(c.traffic.get("warm_frames", 3))
    for i in range(warm):
        feed.frame(i)
    clock.sync()
    cuda_lib.reset_counts()
    setup_s = time.perf_counter() - t0
    log(f"set-up: {t_enter - t0:.3f} s the imports, "
        f"{t_engine - t_enter:.3f} s the engine and its spawn (the card's "
        f"context), {t0 + setup_s - t_engine:.3f} s {warm} warm frames "
        f"(the kernels' library loaded, or built in "
        f"{cuda_lib.build_seconds} s)")

    host0 = _host_usage()
    w = run_window(feed, eng, warm, seconds, clock, want_trace,
                   cuda_lib.launches)
    host = {k: round(v - host0[k], 3) for k, v in _host_usage().items()}
    log(f"host over the window: {host}")
    peak = torch.cuda.max_memory_allocated(device) if clock.cuda else 0
    plain = sum(cuda_lib.plain_calls.values()) if clock.cuda else 0
    frame_ms = w.seconds * 1e3 / max(w.frames, 1)
    iv = sorted(w.intervals_ms) or [0.0]
    log(f"window: {w.frames} frames in {w.seconds:.3f} s, "
        f"{frame_ms:.4f} ms a frame (intervals: median "
        f"{iv[len(iv) // 2]:.4f}, max {iv[-1]:.4f}); set-up {setup_s:.3f} s; "
        f"kernel launches {dict(cuda_lib.launches)}; plain calls {plain}")
    smi = nvidia_smi() if clock.cuda else "not measured (no card)"
    if clock.cuda:
        log(f"card: {torch.cuda.get_device_name(device)}, "
            f"{torch.cuda.device_count()} visible; nvidia-smi: {smi}")

    # The check: the program's state is freed but for the last frame's
    # input and output (and the respawn frame's after the window), then
    # the reference works those frames out again.
    sim_in, sim_out = reference.fields(w.last_in), reference.fields(eng.sim)
    screen, last_i = w.screen, w.last_i
    w.last_in = None
    spawn = None
    if c.traffic.get("respawn"):
        t_more = time.perf_counter()
        spawn = run_to_respawn(feed, eng, last_i, clock)
        log(f"after the window: frames {last_i + 1} to {spawn[0]}, the "
            f"respawn frame, in {time.perf_counter() - t_more:.3f} s")
        if clock.cuda:
            plain = sum(cuda_lib.plain_calls.values())
    del eng, feed
    if clock.cuda:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    numbers = check.numbers(c, seed, last_i, sim_in, sim_out, screen,
                            start_digest, device)
    ctl = {kind: check.control_numbers(c, seed, last_i, sim_in, kind, device)
           for kind in controls}
    if spawn:
        numbers.update(check.spawn_numbers(c, *spawn, device))
        for kind in controls:
            ctl[kind].update(check.control_spawn_numbers(
                c, spawn[0], spawn[1], kind, device))
    log(f"check: {time.perf_counter() - t_check:.3f} s")
    correct, checks = check.verdict(numbers, c.limits)
    if plain:
        correct = False
        checks["plain_calls"] = {"value": plain, "limit": 0}

    metrics = {}
    result = {"correct": correct, "attempted": w.frames,
              "failed": 0 if correct else 1}
    dev = {"platform": "gpu" if clock.cuda else "cpu",
           "kind": (torch.cuda.get_device_name(device) if clock.cuda
                    else "cpu"),
           "count": c.chips, "memory_peak_bytes": peak}
    if not want_trace:
        summary = Summary(frame_ms=frame_ms, intervals_ms=w.intervals_ms,
                          peak_bytes=peak, setup_s=setup_s)
        for m in c.end_to_end:
            v = cell_mod.reader(m["name"])(summary)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        view = w.view
        if view is not None:
            view.spans = dict(w.spans)
            view.config = c.config
            view.power_limit = _power_limit(smi)
            busy = view.busy_us()
            dev["busy_s"] = busy / 1e6
            dev["window_s"] = (view.stretch[1] - view.stretch[0]) / 1e6
            ops = trace.device_ops_by_name(view)
            result["breakdown"] = {"device_ops": [list(x) for x in ops],
                                   "idle_gaps": [list(x) for x in view.gaps]}
        else:
            log(f"no complete trace in {w.traces} tries: the per-layer "
                "metrics read from the trace are not measured")
            view = trace.TraceView(spans=dict(w.spans), config=c.config)
        view.intervals_ms = [v for k, v in enumerate(w.intervals_ms)
                             if k not in w.stretches]
        for m in c.per_layer:
            v = cell_mod.reader(m["name"])(view)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
                log(f"{m['name']}: {v!r} {m['unit']}"
                    + (f" (power limit {view.power_limit})"
                       if m["name"].endswith("_roofline_pct") else ""))
    result["metrics"] = metrics
    result["device"] = dev
    result["checks"] = checks
    return result, numbers, ctl
