"""Where the time of a frame goes, on one GPU.

    python3 frame_profile.py [--model M] [--frames 20] [--classic]
                             [--color-maps] [--paused] [--merge] [--show]
                             [--targets] [--generic] [--backend xla]
    python3 frame_profile.py --cell CELL [--seed S] [--frames 20]
    python3 frame_profile.py --demo PRESET [--quality Q] [--frames 20]
                             [--backend xla]
    python3 frame_profile.py --gathers
    python3 frame_profile.py --k9-k11

Drives `models.build(M)`: "optical-flow-driven" (config 4, the default)
through `step_draw_io` with the feed of `chip_smoke.py` (`feeds.IoFeed`:
a 480x640 u8 camera with a moving bar, 4 pointer paths trimmed to the
last 1/flowDecay ms as the demo trims them; with `--color-maps` also the
demo's three colour maps), or headless through `frame()`:
"default-preview" (config 1 as `bench.py:180-186` builds it:
`chip_smoke.config1`, 720x1280, `flowWeight = 0`, so K2 and K3 run
view-only), "1m-flow" (config 2), "4m-respawn-stress" (config 3, a ball
respawn before every 10th frame, the cadence of `bench.py`'s config 3) and
"16m-live-show" (config 5). `--show` runs config 5's show frame instead
(`chip_smoke.show_frame`: `step_draw_io(bokeh=(3.0, 40.0))` with the
`noiseScale` modulation), the bokeh a stage of its own in reading 3.
`--classic` sets `resident_stream=False`
(the classic carried-force frame); `--paused` pauses the timer after the
warm-up frames (config 4: paused io frames; the others: `frame()` is the
paused draw); `--merge` sets `merge_reorder=True` (the resident frame's
merge reorder, K10 and K11, in place of the flat sort); `--targets` makes
a `direct` target spawn from `chip_smoke.py`'s camera frame first
(`target` 0.003), so the targets ride the resident sort (K4 or K6 with
targets). `--generic` sets `fused_draw=False` (the generic draw: each
pass's segments splatted by K9 and composited, K5 once a step, no
carried force); `--backend xla` sets the splat and gather backends to
"xla" (the JAX package's default off a TPU: the generic draw in plain
PyTorch, no kernel). `--demo PRESET` drives the demo application instead
(`app.TendrilsDemo` at the CLI's defaults, `chip_smoke.DEMO_CLI`: 720x1280,
quality `--quality`, 0 by default: 262,144 particles; 2: 4,194,304),
`PRESET` applied, each frame a `render()` fed as `chip_smoke.py` phase 15
feeds it (`chip_smoke.demo_frame`: the 480x640 camera and 4 pointers);
reading 3 then also times the demo's host stages (the camera frame's f32
grid, the audio sampling). `--cell CELL` drives a cell of the benchmark
instead (`benchmark/`: its configuration's engine and spawn, the rows in
seed `S`'s order, and its traffic mix's frames) in the benchmark's closed
loop, a frame started once the frame two before it has ended. Prints the
readings of the same frame:

  1. wall ms/frame of the plain loop (the end-to-end number);
  2. a `torch.profiler` trace of `--frames` frames: device time by kernel
     name, launches and copies per frame, K2's four kernels together,
     each of the port's kernels by its device ms a launch (to hold
     against its warm and cold times alone in `chip_smoke.py`), and
     the device's busy share of the wall time (kernel, copy and fill time
     over the traced span); then the same trace by the port's spans
     (`utils.profiling.by_span`): each span's host ms, the device ms of
     what it launched, its launches and its host ms in synchronising
     calls, a frame; each layer with the spans nested in it (the logic
     step against its least time, the draw, the sort, the post stage);
     and the share of the device time that no span holds. With the
     merge on (`--merge`, or a cell whose configuration turns it on) the
     merge's device ms (span `draw.merge`), the refused merges' flat sort
     (`draw.fallback`) and the host's wait for the merge's `ok`
     (`draw.wait`'s host time), beside the merged and fallback counts;
  3. each stage alone: the device synchronised before and after it, so
     its wall time is its own host and device time with no overlap. For
     this reading the script wraps the stage functions of the port's
     modules in place and restores them afterwards; the package itself
     never does this. Stages that run inside another are listed under it
     ("of which") and not counted twice.

`--gathers` times the force gathers alone, by device time over 20
back-to-back calls (`chip_smoke.time_calls`), at the shapes their frames
give them: K5 at configs 2, 3 and 5 (`chip_smoke.k5_inputs`), each
against `F.grid_sample` in 7 alternating turns, then the host's time to
enqueue one call of each (`host_us`), also in turns; K7 three times on each
of the seeded classic config-2 stream, a real classic config-2 frame's
after 30 frames, path B's paused config-4 frame's (262,144 rows) and a
config-3 classic frame's (gather mode 2); K8 three times on config 4's
seeded sorted stream; K12 on `chip_smoke.py`'s seeded classic config-2
stream (1,048,576 sorted points, 1080x1920, 2 channels) against
`F.grid_sample` in 7 alternating turns, then three times cold after
each flush (`chip_smoke.time_calls(..., cold="write")` and `"read"`: a
buffer of twice the L2 written, or read, before each call, the flush
left out). It needs only what the package has had
since the gathers were first ported, so it also times an older tree's
kernels (copy this script and `chip_smoke.py` into that tree).

`--k9-k11` times K9 (config 4's pointer frame and 2 x 262,144 spread
samples) and K11 (a real config-3 frame's merge inputs, beside the whole
merge and the flat `torch.sort`) alone, each checked against its plain
version first; see `profile_k9_k11`.

It imports nothing of JAX; it needs a CUDA device.
"""

import argparse
import collections
import dataclasses
import re
import statistics
import subprocess
import time

import torch

from tendrils_tpu_torch.utils import profiling


def _stage_timers(acc, generic=False):
    """Wrap the io frame's stages so that each runs alone between two
    device synchronisations; `acc[name]` collects its wall seconds. With
    `generic` (the generic draw) the colour-map lookup runs inside the
    draw's render colours and is listed under it."""
    from tendrils_tpu_torch import audio, engine, feeds, flow_line, media
    from tendrils_tpu_torch.app import demo
    from tendrils_tpu_torch.ops import optical_flow as of_ops
    from tendrils_tpu_torch.ops import post, render, reorder_cuda, sample
    from tendrils_tpu_torch.ops import splat

    def timed(owner, attr, name):
        fn = getattr(owner, attr)

        def run(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            acc[name] += time.perf_counter() - t0
            return out

        setattr(owner, attr, run)
        return owner, attr, fn

    return [timed(*spec) for spec in (
        (media.OpticalFlow, "set_pixels", "camera upload (set_pixels)"),
        (flow_line.FlowLines, "segments", "pointer segments (host numpy)"),
        (engine, "step_sim", "logic step"),
        (engine, "fused_draw",
         "pack K1 + sort + splat K2 + resolve (K3 or the XLA tail)"),
        (engine, "_draw_generic",
         "generic draw (flow and view passes, composites)"),
        (splat, "splat_segments_accumulate",
         NESTED + "segment samples + point splat (K9 or the f32 scatter; "
         "the flow lines' too)"),
        (render, "particle_colors", NESTED + "render colours per particle"),
        (engine, "reconstruct_resident", "reconstruct K6"),
        (engine, "gather_reconstruct_p1", "gather + reconstruct K4"),
        (engine, "_inject_flow", "flow lines (payload + K9 + composite)"),
        (of_ops, "optical_flow", "optical flow (480x640)"),
        (engine, "_resize_payload", "payload resize to 720x1280"),
        (of_ops, "composite_flow", "optical-flow composite"),
        (engine, "force_from_aux",
         "force gather K8 or K7 (+ decay, un-sort)"),
        (feeds, "image_to_grid", "camera grid as a colour map (host)"),
        (post, "blend", "colour-map blend"),
        (post, "vignette_blur", "vignette blur (post stage)"),
        (post, "bokeh", "bokeh (post stage)"),
        (sample, "sample_uv", (NESTED if generic else "")
         + "colour-map lookup per particle"),
        (reorder_cuda, "merge_reorder",
         NESTED + "merge reorder (K10 + C sort + K11)"),
        (demo, "image_to_grid",
         "camera frame to an f32 grid (host, the demo's feed_video_frame)"),
        (audio.AudioTrigger, "sample", "audio sampling (host numpy)"),
        (audio.AudioTexture, "grid", "audio textures as grids (host)"))]


# Label prefix of the stages that run inside the draw's stage.
NESTED = "  of which: "


def _layer(by, name):
    """Span `name` with the spans nested in it by name, as one
    `SpanTimes`."""
    t = profiling.SpanTimes()
    for k, v in by.items():
        if k and (k == name or k.startswith(name + ".")):
            t.device += v.device
            t.launches += v.launches
            t.sync_us += v.sync_us
    return t


def print_spans(events, n, particles):
    """Reading 2 by the port's spans: `events` of `n` frames of
    `particles` particles."""
    import chip_smoke as cs
    by = profiling.by_span(events)
    print("    by span, a frame: host ms, device ms, launches, sync ms")
    for name in sorted(by, key=lambda k: k or "~"):
        t = by[name]
        print(f"      {name or '(no span)':14} {t.host_us / 1e3 / n:9.4f} "
              f"{t.device_us / 1e3 / n:9.4f} {t.launches / n:7.1f} "
              f"{t.sync_us / 1e3 / n:9.4f}")
    layers = {k: _layer(by, profiling.PREFIX + k)
              for k in ("logic", "draw", "draw.sort", "post")}
    print("    layers, device ms a frame: " + ", ".join(
        f"{k} {t.device_us / 1e3 / n:.4f}" for k, t in layers.items()))
    logic_ms = layers["logic"].device_us / 1e3 / n
    least = cs.bound(cs.LOGIC_BYTES * particles, 0)[0]
    print(f"    logic step: {layers['logic'].launches / n:.1f} launches a "
          f"frame; its {cs.LOGIC_BYTES} B a particle over "
          f"{cs.HBM_BYTES_PER_S:.3g} B/s take {least:.4f} ms: "
          + (f"{100 * least / logic_ms:.3f} %" if logic_ms else "no time"))
    sync = sum(t.sync_us for k, t in by.items() if k) / 1e3 / n
    every = profiling.SpanTimes(device=[d for t in by.values()
                                        for d in t.device])
    outside = by.get(None, profiling.SpanTimes()).device_us
    print(f"    host sync in spans {sync:.4f} ms a frame; device time in no "
          f"span {outside / 1e3 / n:.4f} ms a frame, "
          f"{100 * outside / max(every.device_us, 1e-9):.3f} % of it all")
    print("    longest idle gaps, ms, named span:host operation at their "
          "start: " + "; ".join(f"{name} {ms:.4f}" for name, ms
                                in _named_gaps(events, every.device)))
    return by


def _named_gaps(events, device, top=8):
    """The `top` longest idle gaps of the device from the first span's
    start to the end of its last operation in `device`, `(name, ms)`,
    named by the innermost span and host operation holding their start."""
    from torch.autograd import DeviceType
    cpu = [(ev.name, ev.time_range.start, ev.time_range.end)
           for ev in events if ev.device_type == DeviceType.CPU]
    spans = [c for c in cpu if c[0].startswith(profiling.PREFIX)]
    ops = [c for c in cpu if not c[0].startswith(profiling.PREFIX)]
    if not spans or not device:
        return []
    t, gaps = min(s for _, s, _ in spans), []
    for s, e in sorted(device):
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:top]
    starts = [a for a, _ in gaps]
    return [(f"{sp or '-'}:{op or '-'}", (b - a) / 1e3) for (a, b), sp, op
            in zip(gaps, profiling.innermost(spans, starts),
                   profiling.innermost(ops, starts))]


def k7_streams():
    """K7's inputs `(label, eff, p1, inv_sl, inv_p)`: the seeded classic
    config-2 stream, a real classic config-2 frame's after 30 frames, path
    B's, a config-3 classic frame's (gather mode 2)."""
    import chip_smoke as cs
    from tendrils_tpu_torch import models
    from tendrils_tpu_torch.ops import flow as flow_ops
    s = cs.classic_streams(1 << 20, (1080, 1920), 0.01, 3)
    eff = flow_ops.flow_decayed(cs.random_flow((1080, 1920), 1000.0),
                                1000.0 + cs.DT, 0.005).contiguous()
    yield ("seeded classic config-2 stream", eff, s["sorted"][1],
           1.0 / torch.full((1,), 0.01, device="cuda"), 1.0 / s["pscale"])
    del s, eff
    yield ("real classic config-2 frame after 30 frames",
           *cs.capture_k7(cs.classic(models.build("1m-flow")), 30))
    yield ("paused config-4 frame() with colour maps (path B)",
           *cs.path_b_k7())
    yield ("config-3 classic frame (gather mode 2)",
           *cs.capture_k7(cs.classic(models.build("4m-respawn-stress")), 3))


def host_us(fn, calls=200):
    """The host's time to enqueue one call of `fn`, in us: `calls`
    back-to-back calls with no synchronisation between them, after a warm
    one."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e6


def profile_gathers():
    """`--gathers`: K5, K7, K8 and K12 alone, by device time."""
    import chip_smoke as cs
    from tendrils_tpu_torch.ops import flow as flow_ops, gather_cuda
    print("K5, K7, K8 and K12 alone on "
          f"{torch.cuda.get_device_name(0)}")
    for name in ("1m-flow", "4m-respawn-stress", "16m-live-show"):
        eff, x, y = cs.k5_inputs(name)
        print(f"K5 at {name}: {x.numel()} points, grid {tuple(eff.shape)}")
        fn = lambda: gather_cuda.bilinear_gather(eff, x, y)  # noqa: E731
        library = cs.k5_library(eff, x, y)
        cs.against_library(f"  bilinear_gather ({name})", fn, library)
        ks, ls = [], []
        for _ in range(cs.LIB_ROUNDS):
            ks.append(host_us(fn))
            ls.append(host_us(library))
        print(f"    host enqueue, us a call, {cs.LIB_ROUNDS} turns: K5 "
              f"{statistics.median(ks):.1f} ({min(ks):.1f}-{max(ks):.1f}), "
              f"grid_sample {statistics.median(ls):.1f} ({min(ls):.1f}-"
              f"{max(ls):.1f})")
        del eff, x, y
        torch.cuda.empty_cache()
    for label, eff, p1, inv_sl, inv_p in k7_streams():
        ms = [cs.time_calls(lambda: gather_cuda.bilinear_gather_keyed_q15(
            eff, p1, inv_sl, inv_p=inv_p))[0] for _ in range(3)]
        print(f"K7 on the {label} ({p1.numel()} rows): device "
              f"{statistics.median(ms):.4f} ms (3 timings: "
              f"{', '.join(f'{t:.4f}' for t in ms)})")
        del eff, p1
        torch.cuda.empty_cache()
    s = cs.sorted_streams(512 * 512, (720, 1280), 0.01, 1)
    eff = flow_ops.flow_decayed(cs.random_flow((720, 1280), 1000.0),
                                1000.0 + cs.DT, 0.005).contiguous()
    ms = [cs.time_calls(lambda: gather_cuda.bilinear_gather_keyed_p1(
        eff, s["p1_s"], inv_p=1.0 / s["pscale"]))[0] for _ in range(3)]
    print(f"K8 on config 4's seeded sorted stream (262144 rows): device "
          f"{statistics.median(ms):.4f} ms (3 timings: "
          f"{', '.join(f'{t:.4f}' for t in ms)})")
    del s, eff
    # K12 on chip_smoke's seeded classic config-2 stream, as its phase 3
    # checks it: against grid_sample in turns, then cold.
    s = cs.classic_streams(1 << 20, (1080, 1920), 0.01, 3)
    eff = flow_ops.flow_decayed(cs.random_flow((1080, 1920), 1000.0),
                                1000.0 + cs.DT, 0.005).contiguous()
    xs, ys = cs.k12_points(s["sorted"][1], 1.0 / s["pscale"], 1080, 1920)
    del s
    fn = lambda: gather_cuda.bilinear_gather_keyed(eff, xs, ys)  # noqa: E731
    cs.close("gather_keyed", [fn()],
             [gather_cuda.bilinear_gather_keyed_plain(eff, xs, ys)])
    cs.against_library("K12 on the seeded classic config-2 stream "
                       f"({xs.numel()} points)", fn,
                       cs.k12_library(eff, xs, ys))
    for kind in ("write", "read"):
        ms = [cs.time_calls(fn, cold=kind)[0] for _ in range(3)]
        print(f"  K12 cold (the L2 flushed by a {kind} before each call): "
              f"device {statistics.median(ms):.4f} ms (3 timings: "
              f"{', '.join(f'{t:.4f}' for t in ms)})")


def _turns(label, fns, turns=3):
    """Each of `fns` timed (`chip_smoke.time_calls`) in `turns` alternating
    turns; prints device ms and call ms, median and range."""
    import chip_smoke as cs
    dev = {k: [] for k in fns}
    call = {k: [] for k in fns}
    names = {}
    for _ in range(turns):
        for k, fn in fns.items():
            ms, call_ms, names[k] = cs.time_calls(fn)
            dev[k].append(ms)
            call[k].append(call_ms)
    for k in fns:
        parts = "; ".join(f"{n.split('(')[0][-40:]} {t:.4f}"
                          for n, t in names[k].items())
        print(f"  {label} {k}: device {statistics.median(dev[k]):.4f} ms "
              f"({', '.join(f'{t:.4f}' for t in dev[k])}); call "
              f"{statistics.median(call[k]):.4f} ms "
              f"({', '.join(f'{t:.4f}' for t in call[k])}); last turn "
              f"by kernel: {parts}")


def profile_k9_k11():
    """`--k9-k11`: K9 at config 4's pointer and spread samples and K11 on a
    real config-3 frame's merge inputs, each checked against its plain
    version and timed in 3 turns (device ms by kernel); K9 also after a
    128 MB write, as in a frame."""
    import chip_smoke as cs
    from tendrils_tpu_torch import models
    from tendrils_tpu_torch.ops import reorder_cuda as ro, splat_cuda
    print(f"K9 and K11 alone on {torch.cuda.get_device_name(0)}")
    grid_hw = (720, 1280)
    flush = torch.empty(32 * 2 ** 20, device="cuda")
    for label, *inp in cs.k9_cases():
        want = cs.k9_planes(splat_cuda.splat_accumulate_plain(grid_hw, *inp))
        got = cs.k9_planes(splat_cuda.splat_accumulate(grid_hw, *inp))
        cs.equal_to_plain(f"K9 ({label})", got, want)
        if not torch.equal(got, cs.k9_planes(splat_cuda.splat_accumulate(
                grid_hw, *inp))):
            raise SystemExit(f"K9 ({label}): two calls differ")
        print(f"  K9 ({label}, M = {inp[0].numel()}): equal to the plain "
              "version, the same bits on two calls")
        _turns(f"K9 ({label})", {"splat_accumulate": lambda: (
            splat_cuda.splat_accumulate(grid_hw, *inp))})
        # As in a frame, where the kernels before it leave the 50 MB L2
        # full of their own written lines: a 128 MB write before each call.
        _turns(f"K9 ({label}) after a 128 MB write", {
            "splat_accumulate": lambda: (flush.fill_(1.0),
                                         splat_cuda.splat_accumulate(
                                             grid_hw, *inp))})
        del want, got
    inp, _ = cs.capture_merge_inputs(models.build("4m-respawn-stress"))
    kw = dict(n_tiles=inp["n_tiles"], idx_bits=inp["idx_bits"])
    key, prev, hist = inp["key"], inp["prev_key"], inp["prev_hist"]
    args, _ = ro.merge_plan(key, prev, hist, **kw)
    want = ro.merge_apply_plain(*args, idx_bits=kw["idx_bits"])
    got = ro.merge_apply(*args, idx_bits=kw["idx_bits"])
    if not all(torch.equal(a, b) for a, b in zip(got, want)):
        raise SystemExit("K11 differs from the plain version")
    churn = int((key != prev).sum())
    print(f"  K11 on a config-3 frame's merge inputs ({key.numel()} rows, "
          f"{churn} churned): bit-exact, counts included")
    _turns("K11 (config 3)", {"merge_apply": lambda: ro.merge_apply(
        *args, idx_bits=kw["idx_bits"])})
    _turns("config 3", {
        "merge_reorder": lambda: ro.merge_reorder(key, prev, hist, **kw),
        "torch.sort": lambda: torch.sort(key)})


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default="optical-flow-driven",
                    choices=("optical-flow-driven", "default-preview",
                             "1m-flow", "4m-respawn-stress",
                             "16m-live-show"))
    ap.add_argument("--frames", type=int, default=20)
    ap.add_argument("--classic", action="store_true")
    ap.add_argument("--color-maps", action="store_true")
    ap.add_argument("--paused", action="store_true")
    ap.add_argument("--merge", action="store_true")
    ap.add_argument("--show", action="store_true")
    ap.add_argument("--targets", action="store_true")
    ap.add_argument("--demo", metavar="PRESET", default=None)
    ap.add_argument("--quality", type=int, default=0)
    ap.add_argument("--gathers", action="store_true")
    ap.add_argument("--k9-k11", action="store_true")
    ap.add_argument("--generic", action="store_true")
    ap.add_argument("--backend", default="kernel", choices=("kernel", "xla"))
    ap.add_argument("--cell", default=None)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("frame_profile: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=False).stdout.strip()
    print(f"card: {smi}")
    if args.gathers:
        return profile_gathers()
    if args.k9_k11:
        return profile_k9_k11()
    import chip_smoke
    from tendrils_tpu_torch import models
    from tendrils_tpu_torch.engine import (fused_draw_ok,
                                           merge_reorder_enabled)
    from tendrils_tpu_torch.feeds import IoFeed
    from tendrils_tpu_torch.ops import cuda_lib, spawn
    if args.demo:
        from tendrils_tpu_torch.app import TendrilsDemo
        demo = TendrilsDemo({}, splat_backend=args.backend,
                            gather_backend=args.backend,
                            **chip_smoke.DEMO_CLI)
        demo.quality_change(args.quality)
        demo.apply_preset(args.demo)
        eng = demo.tendrils
    elif args.cell:
        from benchmark import cell, harness, traffic
        c = cell.load(args.cell)
        lib = harness.program_lib()
        eng = cell.make_engine(lib, c.config, args.seed, "cuda")
        feed = traffic.Feed(c.traffic, eng, lib)
    else:
        eng = chip_smoke.config1() if args.model == "default-preview" \
            else models.build(args.model)
        eng.config = dataclasses.replace(eng.config,
                                         resident_stream=not args.classic,
                                         merge_reorder=args.merge,
                                         fused_draw=not args.generic,
                                         splat_backend=args.backend,
                                         gather_backend=args.backend)
        eng.reseed_derived()
    if args.targets:
        eng.state["target"] = 0.003
        sp = chip_smoke.image_spawner("direct")
        sp.speed = 0.3
        sp.set_pixels(chip_smoke.camera_grid(0))
        sp.spawn(eng, target="targets")
    respawn = 10 if args.model == "4m-respawn-stress" else 0

    def headless(i):
        if respawn and i % respawn == 0:
            eng.spawn_shader(lambda p, e: spawn.ball(p, e._frag_xy, 0.6,
                                                     0.01))
        eng.frame()

    if args.demo:
        def step(i):
            chip_smoke.demo_frame(demo, i)
    elif args.cell:
        step = feed.frame
    elif args.show:
        def step(i):
            chip_smoke.show_frame(eng, i)
    elif args.model == "optical-flow-driven":
        step = IoFeed(eng, color_maps=args.color_maps).frame
    else:
        step = headless
    i = 0
    ends = collections.deque(maxlen=2)

    def frames(k):
        nonlocal i
        for _ in range(k):
            if args.cell and len(ends) == 2:
                ends[0].synchronize()
            step(i)
            i += 1
            if args.cell:
                ends.append(torch.cuda.Event())
                ends[-1].record()
        torch.cuda.synchronize()

    frames(3)
    eng.timer.paused = args.paused
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        frames(args.frames)
        walls.append((time.perf_counter() - t0) / args.frames * 1e3)
    if args.cell:
        print(f"the benchmark's cell {args.cell} (seed {args.seed}, "
              f"{eng.config.n} particles, {eng.config.view_res[0]}x"
              f"{eng.config.view_res[1]}) on "
              f"{torch.cuda.get_device_name(0)}")
    elif args.demo:
        print(f"the demo's render() with {args.demo} at quality "
              f"{args.quality} ({eng.config.n} particles, "
              f"{eng.config.view_res[0]}x{eng.config.view_res[1]}, the "
              f"camera and {chip_smoke.DEMO_POINTERS} pointers) on "
              f"{torch.cuda.get_device_name(0)}")
    else:
        print(f"{args.model} (classic {args.classic}, colour maps "
              f"{args.color_maps}, paused {args.paused}, merge "
              f"{args.merge}, show frame {args.show}, live targets "
              f"{args.targets}, generic draw {args.generic}, backend "
              f"{args.backend}) on {torch.cuda.get_device_name(0)}")
    print(f"[1] wall: {statistics.median(walls):.3f} ms/frame (median of 3 "
          f"x {args.frames}: {', '.join(f'{w:.3f}' for w in walls)})")

    from torch.profiler import ProfilerActivity, profile
    cuda_lib.reset_counts()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        frames(args.frames)
        span = (time.perf_counter() - t0) * 1e3
    dev = collections.Counter()
    calls = collections.Counter()
    for ev in prof.key_averages():
        # The port's spans show on the device as annotations, not work.
        if ev.device_type == torch.autograd.DeviceType.CUDA \
                and ev.self_device_time_total > 0 \
                and not getattr(ev, "is_user_annotation", False) \
                and not ev.key.startswith(profiling.PREFIX):
            dev[ev.key] += ev.self_device_time_total / 1e3
            calls[ev.key] += ev.count
    busy = sum(dev.values())
    n = args.frames
    print(f"[2] profiled {n} frames: {span / n:.3f} ms/frame wall, "
          f"{busy / n:.3f} ms/frame of device time in "
          f"{sum(calls.values()) / n:.1f} kernels/copies/fills, busy "
          f"{busy / span:.1%} of the wall")
    for key, ms in dev.most_common(15):
        print(f"    {ms / n:8.4f} ms/frame  {calls[key] / n:6.1f}/frame  "
              f"{key[:90]}")
    k2 = {k: sum(ms for key, ms in dev.items() if f"splat_{k}_kernel" in key)
          for k in ("plan", "tile", "stray", "convert")}
    k2_calls = sum(c for key, c in calls.items()
                   if any(f"splat_{k}_kernel" in key for k in k2))
    print(f"    {sum(k2.values()) / n:8.4f} ms/frame  {k2_calls / n:6.1f}/frame"
          f"  K2 splat in all (plan {k2['plan'] / n:.4f}, tile pass "
          f"{k2['tile'] / n:.4f}, stray pass {k2['stray'] / n:.4f}, "
          f"conversion {k2['convert'] / n:.4f})")
    k9 = {key: ms for key, ms in dev.items() if "splat_points" in key}
    if k9:
        print(f"    {sum(k9.values()) / n:8.4f} ms/frame  "
              f"{sum(calls[k] for k in k9) / n:6.1f}/frame  K9 in all ("
              + ", ".join(f"{re.search(r'splat_points_[a-z_]*', k)[0]} "
                          f"{ms / n:.4f}" for k, ms in k9.items()) + ")")

    own = [(m[1], k) for k in sorted(dev, key=dev.get, reverse=True)
           if (m := re.match(r"(?:void )?[(]anonymous namespace[)]::(\w+)",
                             k))]
    print("    the port's kernels in the frame, device ms a launch x "
          "launches a frame: " + "; ".join(
              f"{name} {dev[k] / calls[k]:.4f} x {calls[k] / n:g}"
              for name, k in own))
    by = print_spans(prof.events(), n, eng.config.n)
    if merge_reorder_enabled(eng.config):
        none = profiling.SpanTimes()
        merge, fallback, wait = (by.get("tt.draw." + k, none)
                                 for k in ("merge", "fallback", "wait"))
        print(f"    the merge, a frame: device ms "
              f"{merge.device_us / 1e3 / n:.4f} (span draw.merge), the "
              f"refused merges' flat sort "
              f"{fallback.device_us / 1e3 / n:.4f} (draw.fallback), the "
              f"host's wait for its ok {wait.host_us / 1e3 / n:.4f} "
              f"(draw.wait); {dict(cuda_lib.events)}")

    acc = collections.Counter()
    patched = _stage_timers(acc, generic=not fused_draw_ok(eng.config))
    t0 = time.perf_counter()
    frames(n)
    wall = (time.perf_counter() - t0) / n * 1e3
    for owner, attr, fn in patched:
        setattr(owner, attr, fn)
    print(f"[3] stages alone (synchronised around each): {wall:.3f} "
          f"ms/frame in all")
    for name, sec in acc.most_common():
        print(f"    {sec / n * 1e3:8.4f} ms/frame  {name}")
    top = sum(sec for name, sec in acc.items() if not name.startswith(NESTED))
    print(f"    {wall - top / n * 1e3:8.4f} ms/frame  the rest "
          "(params, scalars, the sim's bookkeeping, timer)")


if __name__ == "__main__":
    main()
