"""Where the time of a frame goes, on one GPU.

    python3 frame_profile.py [--model M] [--frames 20] [--classic]
                             [--color-maps] [--paused] [--merge]

Drives `models.build(M)`: "optical-flow-driven" (config 4, the default)
through `step_draw_io` with the feed of `chip_smoke.py` (`feeds.IoFeed`:
a 480x640 u8 camera with a moving bar, 4 pointer paths trimmed to the
last 1/flowDecay ms as the demo trims them; with `--color-maps` also the
demo's three colour maps), or headless through `frame()`: "1m-flow"
(config 2), "4m-respawn-stress" (config 3, a ball respawn before every
10th frame, the cadence of `bench.py`'s config 3) and "16m-live-show"
(config 5 without its post stack). `--classic` sets `resident_stream=False`
(the classic carried-force frame); `--paused` pauses the timer after the
warm-up frames (config 4: paused io frames; the others: `frame()` is the
paused draw); `--merge` sets `merge_reorder=True` (the resident frame's
merge reorder, K10 and K11, in place of the flat sort). Prints the
readings of the same frame:

  1. wall ms/frame of the plain loop (the end-to-end number);
  2. a `torch.profiler` trace of `--frames` frames: device time by kernel
     name, launches and copies per frame, and the device's busy share of
     the wall time (kernel, copy and fill time over the traced span);
  3. each stage alone: the device synchronised before and after it, so
     its wall time is its own host and device time with no overlap. For
     this reading the script wraps the stage functions of the port's
     modules in place and restores them afterwards; the package itself
     never does this. Stages that run inside another are listed under it
     ("of which") and not counted twice;
  4. with `--merge`: the plain loop again, with only the host read of the
     merge's `ok` timed (no synchronisation added): the host's wait for
     the device to reach the merge, and the merged and fallback counts.

It imports nothing of JAX; it needs a CUDA device.
"""

import argparse
import collections
import dataclasses
import statistics
import time

import torch


def _stage_timers(acc):
    """Wrap the io frame's stages so that each runs alone between two
    device synchronisations; `acc[name]` collects its wall seconds."""
    from tendrils_tpu_torch import engine, feeds, flow_line, media
    from tendrils_tpu_torch.ops import draw_cuda, optical_flow as of_ops
    from tendrils_tpu_torch.ops import post, reorder_cuda, sample

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
        (sample, "sample_uv", "colour-map lookup per particle"),
        (reorder_cuda, "merge_reorder",
         NESTED + "merge reorder (K10 + C sort + K11)"),
        (draw_cuda, "_read_ok", NESTED + "host read of the merge's ok"))]


# Label prefix of the stages that run inside the draw's stage.
NESTED = "  of which: "


def _ok_timer(acc):
    """Time the host read of the merge's `ok` without synchronising
    around it: its wall time is the host's wait for the device."""
    from tendrils_tpu_torch.ops import draw_cuda
    fn = draw_cuda._read_ok

    def run(ok):
        t0 = time.perf_counter()
        out = fn(ok)
        acc["ok"] += time.perf_counter() - t0
        return out

    draw_cuda._read_ok = run
    return fn


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default="optical-flow-driven",
                    choices=("optical-flow-driven", "1m-flow",
                             "4m-respawn-stress", "16m-live-show"))
    ap.add_argument("--frames", type=int, default=20)
    ap.add_argument("--classic", action="store_true")
    ap.add_argument("--color-maps", action="store_true")
    ap.add_argument("--paused", action="store_true")
    ap.add_argument("--merge", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("frame_profile: no CUDA device")
    from tendrils_tpu_torch import models
    from tendrils_tpu_torch.feeds import IoFeed
    from tendrils_tpu_torch.ops import cuda_lib, spawn
    eng = models.build(args.model)
    eng.config = dataclasses.replace(eng.config,
                                     resident_stream=not args.classic,
                                     merge_reorder=args.merge)
    eng.reseed_derived()
    respawn = 10 if args.model == "4m-respawn-stress" else 0

    def headless(i):
        if respawn and i % respawn == 0:
            eng.spawn_shader(lambda p, e: spawn.ball(p, e._frag_xy, 0.6,
                                                     0.01))
        eng.frame()

    step = IoFeed(eng, color_maps=args.color_maps).frame \
        if args.model == "optical-flow-driven" else headless
    i = 0

    def frames(k):
        nonlocal i
        for _ in range(k):
            step(i)
            i += 1
        torch.cuda.synchronize()

    frames(3)
    eng.timer.paused = args.paused
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        frames(args.frames)
        walls.append((time.perf_counter() - t0) / args.frames * 1e3)
    print(f"{args.model} (classic {args.classic}, colour maps "
          f"{args.color_maps}, paused {args.paused}, merge {args.merge}) on "
          f"{torch.cuda.get_device_name(0)}")
    print(f"[1] wall: {statistics.median(walls):.3f} ms/frame (median of 3 "
          f"x {args.frames}: {', '.join(f'{w:.3f}' for w in walls)})")

    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        frames(args.frames)
        span = (time.perf_counter() - t0) * 1e3
    dev = collections.Counter()
    calls = collections.Counter()
    for ev in prof.key_averages():
        if ev.device_type == torch.autograd.DeviceType.CUDA \
                and ev.self_device_time_total > 0:
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

    acc = collections.Counter()
    patched = _stage_timers(acc)
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
    if args.merge:
        acc = collections.Counter()
        read_ok = _ok_timer(acc)
        cuda_lib.reset_counts()
        t0 = time.perf_counter()
        frames(n)
        wall = (time.perf_counter() - t0) / n * 1e3
        from tendrils_tpu_torch.ops import draw_cuda
        draw_cuda._read_ok = read_ok
        print(f"[4] plain loop {wall:.3f} ms/frame; the host read of the "
              f"merge's ok {acc['ok'] / n * 1e3:.4f} ms/frame; "
              f"{dict(cuda_lib.events)}")


if __name__ == "__main__":
    main()
