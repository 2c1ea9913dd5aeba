"""Where the time of a frame goes, on one GPU.

    python3 frame_profile.py [--model M] [--frames 20]

Drives `models.build(M)`: "optical-flow-driven" (config 4, the default)
through `step_draw_io` with the feed of `chip_smoke.py` (`feeds.IoFeed`:
a 480x640 u8 camera with a moving bar, 4 pointer paths trimmed to the
last 1/flowDecay ms as the demo trims them), or "1m-flow" (config 2)
through `frame()`. Prints three readings of the same frame:

  1. wall ms/frame of the plain loop (the end-to-end number);
  2. a `torch.profiler` trace of `--frames` frames: device time by kernel
     name, launches and copies per frame, and the device's busy share of
     the wall time (kernel, copy and fill time over the traced span);
  3. each stage alone: the device synchronised before and after it, so
     its wall time is its own host and device time with no overlap. For
     this reading the script wraps the stage functions of the port's
     modules in place and restores them afterwards; the package itself
     never does this.

It imports nothing of JAX; it needs a CUDA device.
"""

import argparse
import collections
import statistics
import time

import torch


def _stage_timers(acc):
    """Wrap the io frame's stages so that each runs alone between two
    device synchronisations; `acc[name]` collects its wall seconds."""
    from tendrils_tpu_torch import engine, flow_line, media
    from tendrils_tpu_torch.ops import optical_flow as of_ops

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
        (engine, "fused_draw", "pack K1 + sort + splat K2 + resolve K3"),
        (engine, "reconstruct_resident", "reconstruct K6"),
        (engine, "gather_reconstruct_p1", "gather + reconstruct K4"),
        (engine, "_inject_flow", "flow lines (payload + K9 + composite)"),
        (of_ops, "optical_flow", "optical flow (480x640)"),
        (engine, "_resize_payload", "payload resize to 720x1280"),
        (of_ops, "composite_flow", "optical-flow composite"),
        (engine, "force_from_aux", "force gather K8 (+ decay)"))]


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default="optical-flow-driven",
                    choices=("optical-flow-driven", "1m-flow"))
    ap.add_argument("--frames", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("frame_profile: no CUDA device")
    from tendrils_tpu_torch import models
    from tendrils_tpu_torch.feeds import IoFeed
    eng = models.build(args.model)
    step = IoFeed(eng).frame if args.model == "optical-flow-driven" \
        else lambda i: eng.frame()
    i = 0

    def frames(k):
        nonlocal i
        for _ in range(k):
            step(i)
            i += 1
        torch.cuda.synchronize()

    frames(3)
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        frames(args.frames)
        walls.append((time.perf_counter() - t0) / args.frames * 1e3)
    print(f"{args.model} on {torch.cuda.get_device_name(0)}")
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
    print(f"    {wall - sum(acc.values()) / n * 1e3:8.4f} ms/frame  the rest "
          "(params, scalars, the sim's bookkeeping, timer)")


if __name__ == "__main__":
    main()
