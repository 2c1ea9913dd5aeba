"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints a line; any failure exits non-zero before the result):
  1. the card (nvidia-smi name and power limit), torch and CUDA versions;
  2. build the kernels (nvcc, one process per source, from
     tendrils_tpu_torch/csrc/);
  3. each kernel against its plain PyTorch version on the card, with its
     time beside the plain version's, its bound (the least time the card
     could take: bytes over 3.35 TB/s or operations over 67 TFLOP/s, the
     larger) and, where one PyTorch call computes the same function, that
     call's time. A time is the device time (`torch.profiler`, the
     kernels' own CUDA time summed over 20 back-to-back calls, over 20;
     3 calls for a plain version); beside a kernel's, its call time (CUDA
     events around 20 back-to-back calls, over 20: the host's enqueue
     included). K1-K5 at the config-2 shapes
     (1,048,576 particles, 1080x1920), K6, K8 and K9 at the config-4
     shapes (262,144 particles, 720x1280; K9 at a pointer frame's samples
     and at 2 x 262,144);
  4. config 2 through the user's entry points: `models.build("1m-flow")`,
     two facade frames, `run_headless` for 60 steps. Every kernel of the
     path must have launched and no plain version may have run; the state
     must be alive and finite. Then ms/frame and particle-steps/s as the
     median of 3 timed 60-step runs, and a small run on the card against
     the same run on the CPU (plain versions);
  5. K2's replay contract: the same config-2 frame twice from one converted
     state, each grid channel within 1e-5 of its max (float atomics add in
     run-dependent order), the carried force (gathered from those grids,
     by identity) within 1e-5 of its flow channel's max, and particles
     within atol 1e-4 (by identity);
  6. config 4 through the user's entry points: `models.build(
     "optical-flow-driven")` and `step_draw_io` fed by `media.OpticalFlow`
     (a 480x640 u8 camera with a moving bar, one upload a frame) and
     `flow_line.FlowLines` (4 pointers on circles, their paths trimmed to
     the last 1/flowDecay ms as the demo app trims them): 2 warm
     frames and 3 timed runs of 20 frames; the launch counters, the state,
     and a small run on the card against the same run on the CPU;
  7. path A, the classic carried-force frame at config 2:
     `models.build("1m-flow")` with `resident_stream=False`, two facade
     frames and `run_headless` for 60 steps (the exact p0 and rgba8
     streams through K1/K2, K3, the q15 force gather K7 and its un-sort),
     then 3 timed runs of 60 steps; launch counters, state, and a small
     run on the card against the CPU;
  8. paths B and C at config 4 with the demo's three colour maps
     (`feeds.IoFeed(color_maps=True)`): the running io frame (K1/K2 with
     rgba8 colours), 2 warm frames and 3 timed runs of 20; then, the
     timer paused, 20 paused io frames (a plain draw with the XLA tail)
     and 20 `Tendrils.frame()` calls (the paused draw, the force by K7),
     each timed; launch counters, state, and small runs on the card
     against the CPU.
  9. the merge reorder (`EngineConfig(merge_reorder=True)`) at config 2:
     two facade frames and 60 headless steps with the launch and event
     counts and each frame's churn (every frame must merge exactly when
     its churn fits the n/8 capacity, at least one must, the seeded first
     must fall back), the carry's invariants, then 3 timed runs of 60 on
     and off from one state in turns, and on against off after 5 steps
     by identity; at config 3 (`models.build("4m-respawn-stress")`),
     `bench.py:_bench_3`'s cadence, a ball respawn and 10 headless steps:
     a warm segment and 3 timed ones, on and off, each respawn's first
     frame falling back;
 10. at config 3 one classic frame and one paused `frame()` (gather mode
     2, K7); config 5 (`models.build("16m-live-show")`) headless, on and
     off: 2 warm steps and 3 timed runs of 10.
Phase 3 holds K2 (three launches: the plan, the tile pass in shared
memory, the strays) in every variant on three more sorted streams: a real
config-2 frame's after 30 frames, a classic p0 stream with long segments
(its stray pass must add samples) and a real config-3 frame's (keys in
the merge's order), printing the partition the kernels ran on each (rows
a tile, split tiles, the stray pass's count). It times K5 and K12 against
`F.grid_sample` in alternating turns, and holds the K1/K2 variants with
the p0 and rgba8 streams, K7 and K12 (with `F.grid_sample` as its library
yardstick), K10 and K11 on
the merge inputs recorded from real config-3 and config-2 frames (with
the boolean-mask selection as K10's yardstick and the flat `torch.sort`
printed beside the whole merge) and K1 in gather modes 3 and 2 against
their plain versions. The last three lines are the card, the per-kernel
JSON and the result JSON.
"""

import dataclasses
import itertools
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

STEPS = 60
DT = 1000.0 / 60.0
IO_FRAMES = 20
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
F32_OPS_PER_S = 67e12  # H100 SXM f32 outside the tensor cores
REPS = 20  # back-to-back calls a kernel or a library call is timed over
PLAIN_REPS = 3  # the same for a plain version (up to ~0.4 s a call)
LIB_ROUNDS = 7  # alternating turns of a kernel against its library call
# Kernel -> (source, the TPU kernel it replaces).
KERNELS = {
    "pack": ("tendrils_tpu_torch/csrc/pack.cu",
             "tendrils_tpu/ops/draw_pallas.py:758"),
    "splat": ("tendrils_tpu_torch/csrc/splat.cu",
              "tendrils_tpu/ops/draw_pallas.py:179"),
    "resolve": ("tendrils_tpu_torch/csrc/resolve.cu",
                "tendrils_tpu/ops/draw_pallas.py:1284"),
    "gather_reconstruct": ("tendrils_tpu_torch/csrc/gather.cu",
                           "tendrils_tpu/ops/gather_pallas.py:481"),
    "bilinear_gather": ("tendrils_tpu_torch/csrc/gather.cu",
                        "tendrils_tpu/ops/gather_pallas.py:236"),
    "reconstruct_resident": ("tendrils_tpu_torch/csrc/gather.cu",
                             "tendrils_tpu/ops/draw_pallas.py:1529"),
    "gather_keyed_p1": ("tendrils_tpu_torch/csrc/gather.cu",
                        "tendrils_tpu/ops/gather_pallas.py:425"),
    "splat_points": ("tendrils_tpu_torch/csrc/splat_points.cu",
                     "tendrils_tpu/ops/splat_pallas.py:125"),
    # The K1/K2 variants with the exact p0 stream and/or rgba8 colours.
    "pack_p0_rgba": ("tendrils_tpu_torch/csrc/pack.cu",
                     "tendrils_tpu/ops/draw_pallas.py:758"),
    "pack_rgba": ("tendrils_tpu_torch/csrc/pack.cu",
                  "tendrils_tpu/ops/draw_pallas.py:758"),
    "splat_p0_rgba": ("tendrils_tpu_torch/csrc/splat.cu",
                      "tendrils_tpu/ops/draw_pallas.py:179"),
    "splat_rgba": ("tendrils_tpu_torch/csrc/splat.cu",
                   "tendrils_tpu/ops/draw_pallas.py:179"),
    "gather_keyed_q15": ("tendrils_tpu_torch/csrc/gather.cu",
                         "tendrils_tpu/ops/gather_pallas.py:364"),
    "gather_keyed": ("tendrils_tpu_torch/csrc/gather.cu",
                     "tendrils_tpu/ops/gather_pallas.py:309"),
    # The merge reorder and K1's gather modes 3 and 2.
    "reorder_compact": ("tendrils_tpu_torch/csrc/reorder.cu",
                        "tendrils_tpu/ops/reorder_pallas.py:246"),
    "reorder_apply": ("tendrils_tpu_torch/csrc/reorder.cu",
                      "tendrils_tpu/ops/reorder_pallas.py:295"),
    "pack_g3": ("tendrils_tpu_torch/csrc/pack.cu",
                "tendrils_tpu/ops/draw_pallas.py:758"),
    "pack_p0_rgba_g2": ("tendrils_tpu_torch/csrc/pack.cu",
                        "tendrils_tpu/ops/draw_pallas.py:758"),
}
CONFIG2_PATH = ("pack", "splat", "resolve", "gather_reconstruct",
                "bilinear_gather")
CONFIG4_PATH = ("pack", "splat", "resolve", "bilinear_gather",
                "reconstruct_resident", "gather_keyed_p1", "splat_points")
# Launches a frame of each new path (the others: none); K2 launches
# three kernels a call (the plan, the tile pass, the strays).
K2 = 3
PATH_A = {"pack_p0_rgba": 1, "splat_p0_rgba": K2, "resolve": 1,
          "gather_keyed_q15": 1}
PATH_C_RUNNING = {"pack_rgba": 1, "splat_rgba": K2, "resolve": 1,
                  "reconstruct_resident": 1, "gather_keyed_p1": 1,
                  "splat_points": 1}
PATH_C_PAUSED = {"pack_p0_rgba": 1, "splat_p0_rgba": K2, "splat_points": 1}
PATH_B = {"pack_p0_rgba": 1, "splat_p0_rgba": K2, "gather_keyed_q15": 1}
# The resident frame with the merge on (K1 "pack" is "pack_g3" in gather
# mode 3), with it off at configs 3 and 5, and the gather-mode-2 frames.
MERGE_C2 = {"pack": 1, "splat": K2, "resolve": 1, "gather_reconstruct": 1,
            "reorder_compact": 1, "reorder_apply": 1}
CONFIG3_OFF = {"pack": 1, "splat": K2, "resolve": 1, "gather_reconstruct": 1}
CLASSIC_G2 = {"pack_p0_rgba_g2": 1, "splat_p0_rgba": K2, "resolve": 1,
              "gather_keyed_q15": 1}
PAUSED_G2 = {"pack_p0_rgba_g2": 1, "splat_p0_rgba": K2,
             "gather_keyed_q15": 1}
SEG = 10  # headless steps of a config-3 segment and a config-5 timed run


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def time_calls(fn, reps=REPS):
    """`(device ms, call ms, {kernel: device ms})` of one call of `fn`, each
    over `reps` back-to-back calls after a warm one: the device time of
    the kernels, copies and fills they ran, by `torch.profiler`, summed
    and divided by `reps`; and the time between CUDA events around them,
    divided by `reps`: what a caller pays, the host's enqueue included."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    call_ms = start.elapsed_time(end) / reps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    names = {}
    for ev in prof.key_averages():
        if ev.device_type == torch.autograd.DeviceType.CUDA \
                and ev.self_device_time_total > 0:
            names[ev.key] = names.get(ev.key, 0.0) \
                + ev.self_device_time_total / 1e3 / reps
    if not names:
        fail("torch.profiler recorded no device time")
    return sum(names.values()), call_ms, names


def timed_row(out, name, err, fn, plain_fn, nbytes, ops, library_fn=None,
           plain_reps=PLAIN_REPS, label=""):
    """Time a kernel's wrapper (`fn`), its plain version and, where one
    PyTorch call computes the same function, that call; store the row
    `out[name]` with the bound and print it."""
    ms, call_ms, _ = time_calls(fn)
    plain_ms = time_calls(plain_fn, plain_reps)[0]
    library_ms = None if library_fn is None else time_calls(library_fn)[0]
    b, by = bound(nbytes, ops)
    out[name] = dict(max_abs_err=err, ms=ms, call_ms=call_ms,
                     plain_ms=plain_ms, bound_ms=b, bound_by=by,
                     library_ms=library_ms)
    print(f"  {name}{label}: max |d| {err:.3e}; device {ms:.4f} ms, call "
          f"{call_ms:.4f} ms (plain {plain_ms:.4f} ms, bound {b:.4f} ms by "
          f"{by}" + ("" if library_ms is None
                     else f", library {library_ms:.4f} ms") + ")")


def against_library(name, fn, library_fn, rounds=LIB_ROUNDS):
    """A kernel and the library call that computes the same function,
    each timed by device ms (`time_calls`) in `rounds` alternating turns:
    prints both medians, their ranges and the median of the turns'
    differences, which a gap must clear to stand."""
    ks, ls = [], []
    for _ in range(rounds):
        ks.append(time_calls(fn)[0])
        ls.append(time_calls(library_fn)[0])
    diff = statistics.median(k - lib for k, lib in zip(ks, ls))
    print(f"  {name} against the library call, {rounds} alternating turns "
          f"of {REPS} calls: device {statistics.median(ks):.4f} ms "
          f"({min(ks):.4f}-{max(ks):.4f}), library "
          f"{statistics.median(ls):.4f} ms ({min(ls):.4f}-{max(ls):.4f}); "
          f"kernel - library, median of the turns {diff * 1e3:+.2f} us")


def bound(nbytes, ops):
    """The least time (ms) the card could take: bytes moved once over the
    memory rate, operations over the f32 rate; the larger, and which."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def touched_texels(x, y, h, w):
    """Distinct texels among the CLAMP_TO_EDGE bilinear corners at texel
    coords (x, y): what a gather must read of its grid for these points."""
    gx = torch.clamp(x, 0.5, w - 0.5) - 0.5
    gy = torch.clamp(y, 0.5, h - 0.5) - 0.5
    x0 = torch.clamp(torch.floor(gx).long(), 0, w - 1)
    y0 = torch.clamp(torch.floor(gy).long(), 0, h - 1)
    x1 = torch.clamp(x0 + 1, max=w - 1)
    y1 = torch.clamp(y0 + 1, max=h - 1)
    idx = torch.cat([y0 * w + x0, y0 * w + x1, y1 * w + x0, y1 * w + x1])
    return torch.unique(idx).numel()


def p1_coords(p1, inv_p, h, w):
    """Texel coords of packed p1 words, as K4/K8 unpack and clamp them."""
    from tendrils_tpu_torch.ops.tile_geom import HALF, PAD_LO_H, PAD_LO_W
    x = torch.clamp((p1 & HALF).float() * inv_p, PAD_LO_W + 0.5,
                    PAD_LO_W + w - 0.5) - PAD_LO_W
    y = torch.clamp((p1 >> 15).float() * inv_p, PAD_LO_H + 0.5,
                    PAD_LO_H + h - 0.5) - PAD_LO_H
    return x, y


def resident_inputs(rng, n, grid_hw, speed_limit):
    """A resident draw's inputs after a step: positions a little beyond
    the view, velocities within the speed limit, a tenth of the rows dead,
    permuted row ids."""
    h, w = grid_hw
    vs = np.float32(max(h, w)) / np.asarray([w, h], np.float32)
    pos = (rng.uniform(-1.02, 1.02, (2, n)) / vs[:, None]).astype(np.float32)
    vel = (rng.uniform(-0.7, 0.7, (2, n)) * speed_limit).astype(np.float32)
    dead = rng.random(n) < 0.1
    pos[:, dead] = -1.0e6
    vel[:, dead] = 0.0
    return pos, vel, (~dead).astype(np.float32), \
        rng.permutation(n).astype(np.int32), vs


def sorted_streams(n, grid_hw, sl, seed):
    """Pack (K1) and sort a resident draw's inputs: the draw's scalars,
    the pack's words, and the sorted p1, vl and exact positions."""
    from tendrils_tpu_torch.ops import draw_cuda
    from tendrils_tpu_torch.ops.tile_geom import pad_dims
    dev = torch.device("cuda")
    h, w = grid_hw
    time_, fdecay = 1000.0, 0.005
    pos, vel, live, idx, vs = resident_inputs(np.random.default_rng(seed), n,
                                              grid_hw, sl)
    t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    pos_t, vs_t = t(pos), t(vs)
    p1 = torch.stack([(pos_t[0] * vs_t[0] * 0.5 + 0.5) * w,
                      (pos_t[1] * vs_t[1] * 0.5 + 0.5) * h], dim=-1)
    pscale = draw_cuda._pos_scale(*pad_dims(h, w))
    scal = draw_cuda._draw_scal(
        sl, time_, 5.0, 1.0, 1e-6, float(np.sin(time_ * fdecay)), fdecay,
        t(np.float32([1, 1, 1, 0.5])), t(np.float32([1, 1, 1, 0.04])),
        t(np.float32([0.2, 0.5, 0.8, 1.0]) * np.float32(0.4)), vs_t, dev)
    pack_args = (scal, p1, t(vel), t(live), t(idx))
    words = draw_cuda.pack(*pack_args, grid_hw=grid_hw, pscale=pscale)
    keym_s, perm = torch.sort(words[0])
    return dict(scal=scal, pack_args=pack_args, words=words, pscale=pscale,
                keym_s=keym_s, p1_s=words[1][perm], vl_s=words[2][perm],
                x_s=pos_t[0][perm], y_s=pos_t[1][perm], pos=pos_t, vs=vs_t)


def random_flow(grid_hw, time_):
    h, w = grid_hw
    dev = torch.device("cuda")
    flow = torch.rand((4, h, w), device=dev) * 0.02 - 0.01
    flow[2] = torch.rand((h, w), device=dev) * time_
    flow[3] = torch.rand((h, w), device=dev)
    return flow


def close(name, got, want):
    """K3-K5, K8: rtol 1e-5 (atol 1e-6 for values near 0)."""
    err = max((a - b).abs().max().item() for a, b in zip(got, want))
    for a, b in zip(got, want):
        if not torch.allclose(a, b, rtol=1e-5, atol=1e-6):
            fail(f"{name}: max |d| {err:.3e}")
    return err


def within_channel_max(name, got, want):
    """K2, K9: float atomics add in run-dependent order, so |d| <= 1e-5 x
    the channel's max. `got`, `want`: [C, ...]."""
    c = want.shape[0]
    scale = want.abs().reshape(c, -1).amax(dim=1)
    err = (got - want).abs().reshape(c, -1).amax(dim=1)
    if not (err <= 1e-5 * scale).all():
        fail(f"{name}: per-channel max |d| {err.tolist()} vs max "
             f"{scale.tolist()}")
    return err.max().item()


def kw_plain(kw):
    """`splat`'s keywords less the keys' id bits (its plain version has no
    use for them)."""
    return {k: v for k, v in kw.items() if k != "idx_bits"}


def splat_work(keym_s, vl_s, hp, wp, words):
    """K2's bytes and operations on a sorted stream (2 samples a segment):
    `words` i32 words a row read, the padded 11-channel accumulator
    written once; each live sample adds its box footprints (a width-W box
    covers ceil(W) + 1 texels an axis but where it lies on texel edges:
    flowWidth 5 over 5 channels, lineWidth 1 over 6) at 3 operations a
    deposit, plus ~80 to derive it."""
    live_samples = 2 * ((vl_s >> 30) & 1).sum().item()
    deposits = live_samples * ((5 + 1) ** 2 * 5 + (1 + 1) ** 2 * 6)
    return (4 * words * keym_s.numel() + 11 * hp * wp * 4 + 128,
            3 * deposits + 80 * live_samples)


def p0_words(scal, p1, vl, grid_hw, pscale):
    """p0 words for a stream without them: p1 less the step its velocity
    word re-derives (the splat's derive_p0), quantised as K1 quantises."""
    from tendrils_tpu_torch.ops.tile_geom import HALF, PAD_LO_H, PAD_LO_W
    h, w = grid_hw
    inv_p = 1.0 / pscale
    vel_u = vl & ((1 << 30) - 1)
    vx = ((vel_u & HALF).float() * (2.0 / HALF) - 1.0) * scal[0]
    vy = ((vel_u >> 15).float() * (2.0 / HALF) - 1.0) * scal[0]
    x = torch.clamp((p1 & HALF).float() * inv_p - vx * (scal[30] * 0.5 * w),
                    1.0, PAD_LO_W + w + 1.0)
    y = torch.clamp((p1 >> 15).float() * inv_p - vy * (scal[31] * 0.5 * h),
                    1.0, PAD_LO_H + h + 1.0)
    return (torch.round(y * pscale).int() * (HALF + 1)
            + torch.round(x * pscale).int())


def exact_splat(scal, p1, vl, **kw):
    """K2's deposits (the plain version's per-sample arithmetic) summed in
    float64: the exact sum both f32 versions approximate."""
    from tendrils_tpu_torch.ops import draw_cuda
    from tendrils_tpu_torch.ops.tile_geom import pad_dims
    hp, wp = pad_dims(*kw["grid_hw"])
    _, _, groups = draw_cuda._splat_terms(scal, p1, vl, **kw)
    groups = [(chans.double(), ch0, inv_w.double(),
               tuple(t.double() for t in ys), tuple(t.double() for t in xs))
              for chans, ch0, inv_w, ys, xs in groups]
    acc = torch.zeros(draw_cuda.N_CHAN * hp * wp, dtype=torch.float64,
                      device=p1.device)
    return draw_cuda._add_boxes(acc, groups, hp, wp).reshape(-1, hp, wp)


def check_splat_stream(label, scal, keym_s, p1, vl, *, idx_bits, samples,
                       grid_hw, pscale, p0=None, rgba=None, exact=False):
    """K2 on one sorted stream in every variant (words the stream lacks
    made up: p0 by `p0_words`, rgba8 seeded), each within 1e-5 of each
    channel's max of `splat_plain`. Prints the partition the kernels ran
    on the stream's own variant (`draw_cuda.splat_planned`), its tile
    ranges held to `torch.searchsorted`: rows a key tile and an output
    tile's weighted source rows (max, median), the split tiles and the
    samples the stray pass added. With `exact`, the
    stream's own variant also within 1e-5 of each channel's max of
    `exact_splat`, the plain version's distance from it printed beside.
    Returns `({variant: max |d|}, strays)`."""
    from tendrils_tpu_torch.ops import draw_cuda
    n = p1.numel()
    p0_w = p0 if p0 is not None else p0_words(scal, p1, vl, grid_hw, pscale)
    rgba_w = rgba if rgba is not None else torch.as_tensor(
        np.random.default_rng(9).integers(0, 1 << 31, n).astype(np.int32),
        device=p1.device)
    kw = dict(idx_bits=idx_bits, samples=samples, grid_hw=grid_hw,
              pscale=pscale)
    errs = {}
    for name, v_p0, v_rgba in (("splat", None, None),
                               ("splat_rgba", None, rgba_w),
                               ("splat_p0_rgba", p0_w, rgba_w)):
        want = draw_cuda.splat_plain(scal, p1, vl, p0=v_p0, rgba=v_rgba,
                                     **kw_plain(kw))
        got = draw_cuda.splat(scal, keym_s, p1, vl, p0=v_p0, rgba=v_rgba,
                              **kw)
        errs[name] = within_channel_max(f"{name} ({label})", got, want)
        del got, want
    _, info, queue = draw_cuda.splat_planned(
        scal, keym_s, p1, vl, p0=p0, rgba=rgba, **kw)
    info = info.reshape(-1, draw_cuda.SPLAT_INFO)
    # The plan's searches: each tile's own rows, from its first to the
    # next tile's.
    starts = torch.searchsorted(
        keym_s >> idx_bits, torch.arange(info.shape[0] + 1, device=p1.device,
                                         dtype=torch.int32), out_int32=True)
    if not (torch.equal(info[:, 4], starts[:-1])
            and torch.equal(info[:, 5], starts[1:])):
        fail(f"K2 ({label}): the plan's tile ranges differ from "
             "torch.searchsorted of the sorted keys' tiles")
    rows = torch.diff(starts).float()
    work = info[:, 7].float()
    chunk = draw_cuda.split_chunk(n)
    split = (info[:, 6] > 1).sum().item()
    queued, strays = queue[:2].tolist()
    if queued > draw_cuda.queue_cap(n, chunk) or (split == 0) != (queued == 0):
        fail(f"K2 ({label}): {queued} parts queued for {split} split tiles "
             f"(room for {draw_cuda.queue_cap(n, chunk)})")
    print(f"  K2 on the {label} ({n} rows, gather bits {idx_bits}): every "
          f"variant within 1e-5 of each channel's max of the plain version "
          f"(max |d| " + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
          + f"); rows a key tile max {rows.max().item():.0f}, median "
          f"{rows.median().item():.0f}; an output tile's weighted source "
          f"rows (sixteenths) max {work.max().item():.0f}, median "
          f"{work.median().item():.0f}, {split} of {info.shape[0]} tiles "
          f"split (> {chunk}) into {queued} parts; {strays} of "
          f"{samples * n} samples stray")
    if exact:
        native = dict(kw_plain(kw), p0=p0, rgba=rgba)
        ref = exact_splat(scal, p1, vl, **native)
        scale = ref.abs().reshape(ref.shape[0], -1).amax(dim=1)

        def rel(a):
            d = (a.double() - ref).abs().reshape(ref.shape[0], -1)
            return (d.amax(dim=1) / scale).max().item()

        got = rel(draw_cuda.splat(scal, keym_s, p1, vl, idx_bits=idx_bits,
                                  **native))
        plain = rel(draw_cuda.splat_plain(scal, p1, vl, **native))
        if got > 1e-5:
            fail(f"K2 ({label}) against the float64 sum: {got:.3e} of a "
                 "channel's max")
        print(f"    against a float64 sum of the same deposits: K2 within "
              f"{got:.3e} of each channel's max, the plain version "
              f"{plain:.3e}")
        del ref
    return errs, strays


def check_config2_kernels():
    """K1-K5 at config-2 shapes: {name: dict(max_abs_err, ms, call_ms,
    plain_ms, bound_ms, bound_by, library_ms)}."""
    from tendrils_tpu_torch.ops import draw_cuda, gather_cuda
    from tendrils_tpu_torch.ops.tile_geom import pad_dims
    dev = torch.device("cuda")
    n, (h, w) = 1 << 20, (1080, 1920)
    hp, wp = pad_dims(h, w)
    sl, time_, fdecay = 0.01, 1000.0, 0.005
    s = sorted_streams(n, (h, w), sl, 0)
    pscale, scal = s["pscale"], s["scal"]
    out = {}

    def rec(name, err, fn, plain_fn, nbytes, ops, library_fn=None):
        timed_row(out, name, err, fn, plain_fn, nbytes, ops, library_fn)

    # K1: integer words, bit-exact. Reads p1_pix, vel, live, idx (24 B a
    # row) and the scalars, writes 3 words (12 B); ~60 operations a row.
    kw = dict(grid_hw=(h, w), pscale=pscale)
    got = s["words"]
    want = draw_cuda.pack_plain(*s["pack_args"], **kw)
    for name, a, b in zip(("keym", "p1", "vl"), got, want):
        if not torch.equal(a, b):
            fail(f"pack {name}: {(a != b).sum().item()} words differ")
    rec("pack", 0.0, lambda: draw_cuda.pack(*s["pack_args"], **kw),
        lambda: draw_cuda.pack_plain(*s["pack_args"], **kw),
        36 * n + 128, 60 * n)

    # K2 on the sorted stream (gather mode 1), in every variant; timed as
    # the resident frame runs it.
    p1_s, vl_s = s["p1_s"], s["vl_s"]
    args = (scal, s["keym_s"], p1_s, vl_s)
    kw = dict(idx_bits=20, samples=2, grid_hw=(h, w), pscale=pscale)
    acc = draw_cuda.splat(*args, **kw)
    errs, _ = check_splat_stream("seeded config-2 stream", *args, **kw)
    rec("splat", errs["splat"], lambda: draw_cuda.splat(*args, **kw),
        lambda: draw_cuda.splat_plain(scal, *args[2:], **kw_plain(kw)),
        *splat_work(s["keym_s"], vl_s, hp, wp, 3))

    # K3: reads the accumulator's content region (11 channels), the flow
    # and the view, writes both grids and eff: 116 B a pixel.
    flow = random_flow((h, w), time_)
    view = torch.rand((4, h, w), device=dev)
    rscal = draw_cuda._resolve_scal(
        torch.tensor([0.1333, 0.1333, 0.1333, 0.05], device=dev), 0.0,
        time_, time_ + DT, fdecay, 5.0, 1.0, dev)
    args = (rscal, acc, flow, view)
    res = draw_cuda.resolve(*args, want_eff=True)
    rec("resolve",
        close("resolve", res, draw_cuda.resolve_plain(*args, want_eff=True)),
        lambda: draw_cuda.resolve(*args, want_eff=True),
        lambda: draw_cuda.resolve_plain(*args, want_eff=True),
        116 * h * w, 40 * h * w)

    # K4: reads p1, npx, npy, vl (16 B a row) and the texels its rows
    # touch (2 channels), writes force, particles, previous (40 B a row).
    eff = res[2]
    args = (eff, p1_s, s["x_s"], s["y_s"], vl_s,
            torch.full((1,), sl, device=dev))
    kw = dict(inv_p=1.0 / pscale)
    texels = touched_texels(*p1_coords(p1_s, 1.0 / pscale, h, w), h, w)
    rec("gather_reconstruct",
        close("gather_reconstruct", gather_cuda.gather_reconstruct_p1(
            *args, **kw), gather_cuda.gather_reconstruct_plain(*args, **kw)),
        lambda: gather_cuda.gather_reconstruct_p1(*args, **kw),
        lambda: gather_cuda.gather_reconstruct_plain(*args, **kw),
        56 * n + 8 * texels, 40 * n)

    # K5 at the particles' positions, plus points on and past the edges:
    # reads x, y and the touched texels, writes C values a point. The
    # library call is `grid_sample` (bilinear, border padding, unaligned
    # corners) on the same grid and points, coordinates normalised before.
    pos, vs = s["pos"], s["vs"]
    x = ((pos[0] * vs[0]) * 0.5 + 0.5) * w
    y = ((pos[1] * vs[1]) * 0.5 + 0.5) * h
    x[:4] = torch.tensor([w - 0.5, w, w + 3.0, -2.0], device=dev)
    y[:4] = torch.tensor([h - 0.5, h, 0.25, h + 5.0], device=dev)
    got = gather_cuda.bilinear_gather(eff, x, y)
    norm = torch.stack([x / w * 2.0 - 1.0, y / h * 2.0 - 1.0],
                       dim=-1)[None, None]

    def library():
        return torch.nn.functional.grid_sample(
            eff[None], norm, mode="bilinear", padding_mode="border",
            align_corners=False)

    lib_err = (library()[0, :, 0] - got).abs().max().item()
    rec("bilinear_gather",
        close("bilinear_gather", [got],
              [gather_cuda.bilinear_gather_plain(eff, x, y)]),
        lambda: gather_cuda.bilinear_gather(eff, x, y),
        lambda: gather_cuda.bilinear_gather_plain(eff, x, y),
        n * (8 + 2 * 4) + 2 * 4 * touched_texels(x, y, h, w), 20 * n,
        library_fn=library)
    print(f"  (grid_sample against K5: max |d| {lib_err:.3e})")
    against_library("bilinear_gather",
                    lambda: gather_cuda.bilinear_gather(eff, x, y), library)
    return out


def check_config4_kernels():
    """K6, K8, K9 at config-4 shapes, and K4 == K8 + K6 bit for bit."""
    from tendrils_tpu_torch.feeds import pointer_lines, trail_ms
    from tendrils_tpu_torch.state import default_state
    from tendrils_tpu_torch.ops import coords, draw_cuda, flow as flow_ops
    from tendrils_tpu_torch.ops import gather_cuda, splat, splat_cuda
    dev = torch.device("cuda")
    n, (h, w) = 512 * 512, (720, 1280)
    sl, time_ = 0.01, 1000.0
    s = sorted_streams(n, (h, w), sl, 1)
    out = {}

    def rec(name, err, fn, plain_fn, nbytes, ops, label=""):
        timed_row(out, name, err, fn, plain_fn, nbytes, ops, label=label)

    # K6, bit-exact (--fmad=false): reads npx, npy, vl (12 B a row),
    # writes particles and previous (32 B a row); ~10 operations a row.
    sl_t = torch.full((1,), sl, device=dev)
    args = (s["x_s"], s["y_s"], s["vl_s"], sl_t)
    k6 = draw_cuda.reconstruct_resident(*args)
    for a, b in zip(k6, draw_cuda.reconstruct_resident_plain(*args)):
        if not torch.equal(a, b):
            fail(f"reconstruct_resident: {(a != b).sum().item()} values "
                 "differ")
    rec("reconstruct_resident", 0.0,
        lambda: draw_cuda.reconstruct_resident(*args),
        lambda: draw_cuda.reconstruct_resident_plain(*args),
        44 * n, 10 * n)

    # K8 from the decayed flow: reads p1 (4 B a row) and the touched
    # texels (2 channels), writes the force (8 B a row).
    eff = flow_ops.flow_decayed(random_flow((h, w), time_), time_ + DT,
                                0.005).contiguous()
    inv_p = 1.0 / s["pscale"]
    k8 = gather_cuda.bilinear_gather_keyed_p1(eff, s["p1_s"], inv_p=inv_p)
    err = close("gather_keyed_p1", [k8],
                [gather_cuda.bilinear_gather_keyed_p1_plain(
                    eff, s["p1_s"], inv_p=inv_p)])
    fused = gather_cuda.gather_reconstruct_p1(eff, s["p1_s"], *args[:3],
                                              sl_t, inv_p=inv_p)
    if not all(torch.equal(a, b) for a, b in zip(fused, (k8, *k6))):
        fail("K4 != K8 + K6")
    texels = touched_texels(*p1_coords(s["p1_s"], inv_p, h, w), h, w)
    rec("gather_keyed_p1", err,
        lambda: gather_cuda.bilinear_gather_keyed_p1(
            eff, s["p1_s"], inv_p=inv_p),
        lambda: gather_cuda.bilinear_gather_keyed_p1_plain(
            eff, s["p1_s"], inv_p=inv_p),
        12 * n + 8 * texels, 20 * n)
    print("  K4 == K8 + K6 bit for bit")

    # K9 at a pointer frame's samples (4 pointers, paths of the default
    # flowDecay's 200 ms, 5 crest rows, flow_samples 2: the config-4 path)
    # and at 2 x 262,144 samples spread over the grid and past its edges.
    # Reads x, y, alpha and 4 payload values (28 B a sample), writes the
    # 6-plane accumulator once; 12 operations a valid corner.
    lines = pointer_lines(4, time_, trail_ms(default_state()["flowDecay"]))
    p0, p1, vel, width = lines.segments(time_, coords.cover_aspect((w, h)),
                                        (h, w))
    t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    payload = flow_ops.flow_payload(t(vel), time_, sl)
    x, y, a = splat.segment_samples(t(p0), t(p1), payload[3], 2, 1, width)
    cases = [("pointer", x, y, torch.repeat_interleave(payload, 2, dim=1),
              a)]
    rng = np.random.default_rng(2)
    m = 2 * n
    cases.append(("spread", t(rng.uniform(-2, w + 2, m).astype(np.float32)),
                  t(rng.uniform(-2, h + 2, m).astype(np.float32)),
                  t(rng.uniform(-0.01, 0.01, (4, m)).astype(np.float32)),
                  t(rng.uniform(0, 0.9, m).astype(np.float32))))
    def planes(r):  # (num, wsum, logt) -> f32[C + 2, H, W]
        return torch.cat([r[0], r[1][None], r[2][None]])

    for label, x, y, vals, alpha in reversed(cases):
        sargs = ((h, w), x, y, vals, alpha)
        err = within_channel_max(
            f"splat_points ({label})",
            planes(splat_cuda.splat_accumulate(*sargs)),
            planes(splat_cuda.splat_accumulate_plain(*sargs)))
        x0, y0 = torch.floor(x - 0.5), torch.floor(y - 0.5)
        corners = sum(((x0 + dx >= 0) & (x0 + dx < w) & (y0 + dy >= 0)
                       & (y0 + dy < h) & (alpha != 0)).sum().item()
                      for dx in (0, 1) for dy in (0, 1))
        # The pointer case, the config-4 path's, is recorded last.
        rec("splat_points", err,
            lambda: splat_cuda.splat_accumulate(*sargs),
            lambda: splat_cuda.splat_accumulate_plain(*sargs),
            x.numel() * 28 + 6 * h * w * 4, 12 * corners,
            label=f" ({label}, M = {x.numel()})")
    return out


def classic_streams(n, grid_hw, sl, seed, exact_p0=True, jump=0.0,
                    gather=None):
    """A draw's inputs with per-particle colours (`mapped`, a textured
    colour map's lookup times colorMapAlpha) packed (K1, in `gather` mode:
    1 by default) and sorted: with `exact_p0` the classic draw's (the p0
    stream, row ids arange(N)), else the resident frame's (key_recon,
    permuted ids). `jump`: the share of rows whose p0 lies anywhere on the
    grid, as after a respawn (segments across tiles)."""
    from tendrils_tpu_torch.ops import draw_cuda
    dev = torch.device("cuda")
    h, w = grid_hw
    time_, fdecay = 1000.0, 0.005
    rng = np.random.default_rng(seed)
    pos, vel, live, idx, vs = resident_inputs(rng, n, grid_hw, sl)
    if exact_p0:
        idx = np.arange(n, dtype=np.int32)
    t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    pos_t, vel_t, vs_t = t(pos), t(vel), t(vs)
    scale = torch.tensor([w * 0.5, h * 0.5], device=dev)
    p1 = torch.stack([(pos_t[0] * vs_t[0] * 0.5 + 0.5) * w,
                      (pos_t[1] * vs_t[1] * 0.5 + 0.5) * h], dim=-1)
    p0 = (p1 - vel_t.T * vs_t * scale).contiguous() if exact_p0 else None
    if jump:
        far = t(rng.random(n) < jump)
        p0[far] = t(rng.uniform(0, 1, (n, 2)).astype(np.float32)
                    * np.float32([w, h]))[far]
    mapped = t(rng.uniform(0.0, 1.0, (4, n)).astype(np.float32)
               * np.float32(0.4))
    pscale = draw_cuda.pos_scale_for(grid_hw)
    scal = draw_cuda._draw_scal(
        sl, time_, 5.0, 1.0, 1e-6, float(np.sin(time_ * fdecay)), fdecay,
        t(np.float32([1, 1, 1, 0.5])), t(np.float32([1, 1, 1, 0.04])),
        torch.zeros(4, device=dev),
        torch.zeros(2, device=dev) if exact_p0 else vs_t, dev)
    pack_args = (scal, p1, vel_t, t(live), t(idx))
    pack_kw = dict(grid_hw=grid_hw, pscale=pscale, p0_pix=p0, pos=pos_t,
                   mapped=mapped, gather=gather)
    words = draw_cuda.pack(*pack_args, **pack_kw)
    keym_s, perm = torch.sort(words[0])
    return dict(scal=scal, pack_args=pack_args, pack_kw=pack_kw, words=words,
                pscale=pscale, bits=draw_cuda._idx_bits(
                    1 if gather is None else gather),
                sorted=[keym_s] + [None if a is None else a[perm]
                                   for a in words[1:]])


def check_variant_pack_splat(name, n, grid_hw, s, in_bytes, out):
    """A K1 variant bit-exact and its K2 variant within 1e-5 of each
    channel's max, against their plain versions, timed (the bound counts
    the variant's streams)."""
    from tendrils_tpu_torch.ops import draw_cuda
    from tendrils_tpu_torch.ops.tile_geom import pad_dims
    h, w = grid_hw
    hp, wp = pad_dims(h, w)
    got = s["words"]
    want = draw_cuda.pack_plain(*s["pack_args"], **s["pack_kw"])
    for field, a, b in zip(("keym", "p1", "vl", "p0", "rgba"), got, want):
        if (a is None) != (b is None) or (a is not None
                                          and not torch.equal(a, b)):
            fail(f"pack_{name} {field}: words differ")
    words = sum(a is not None for a in got)
    timed_row(out, "pack_" + name, 0.0,
              lambda: draw_cuda.pack(*s["pack_args"], **s["pack_kw"]),
              lambda: draw_cuda.pack_plain(*s["pack_args"], **s["pack_kw"]),
              in_bytes * n + 4 * words * n + 128, 130 * n)
    keym_s, p1_s, vl_s, p0_s, rgba_s = s["sorted"]
    kw = dict(idx_bits=s["bits"], samples=2, grid_hw=grid_hw,
              pscale=s["pscale"], p0=p0_s, rgba=rgba_s)
    args = (s["scal"], keym_s, p1_s, vl_s)
    err = within_channel_max(f"splat_{name}", draw_cuda.splat(*args, **kw),
                             draw_cuda.splat_plain(s["scal"], p1_s, vl_s,
                                                   **kw_plain(kw)))
    timed_row(out, "splat_" + name, err, lambda: draw_cuda.splat(*args, **kw),
              lambda: draw_cuda.splat_plain(s["scal"], p1_s, vl_s,
                                            **kw_plain(kw)),
              *splat_work(keym_s, vl_s, hp, wp, words))


def check_slice3_kernels():
    """At config-2 shapes (1,048,576 rows, 1080x1920): K1/K2 with the
    exact p0 and rgba8 streams, K7 and K12 against their plain versions;
    at config-4 shapes (262,144 rows, 720x1280): K1/K2 with key_recon and
    rgba8 (the textured resident frame)."""
    from tendrils_tpu_torch.ops import flow as flow_ops, gather_cuda
    from tendrils_tpu_torch.ops.tile_geom import HALF, PAD_LO_H, PAD_LO_W
    dev = torch.device("cuda")
    n, (h, w) = 1 << 20, (1080, 1920)
    sl, time_ = 0.01, 1000.0
    out = {}
    s = classic_streams(n, (h, w), sl, 3)
    # K1 reads p0, p1, vel, pos (8 B each), mapped (16 B), live, idx (4 B
    # each) a row; K2 the four sorted words.
    check_variant_pack_splat("p0_rgba", n, (h, w), s, 56, out)

    # K7 at the sorted p1 from the decayed flow: reads p1 (4 B a row) and
    # the touched texels (2 channels), writes one word a row; ~30
    # operations a row.
    eff = flow_ops.flow_decayed(random_flow((h, w), time_), time_ + DT,
                                0.005).contiguous()
    p1_s = s["sorted"][1]
    inv_p = 1.0 / s["pscale"]
    inv_sl = 1.0 / torch.full((1,), sl, device=dev)
    k7 = gather_cuda.bilinear_gather_keyed_q15(eff, p1_s, inv_sl,
                                               inv_p=inv_p)
    ref = gather_cuda.bilinear_gather_keyed_q15_plain(eff, p1_s, inv_sl,
                                                      inv_p=inv_p)
    d = torch.maximum(((k7 & HALF) - (ref & HALF)).abs(),
                      ((k7 >> 15) - (ref >> 15)).abs())
    if d.max().item() > 1:
        fail(f"gather_keyed_q15: a q15 field differs by {d.max().item()}")
    texels = touched_texels(*p1_coords(p1_s, inv_p, h, w), h, w)
    print(f"  gather_keyed_q15: {(k7 != ref).sum().item()} of {n} words "
          f"differ, each q15 field by <= {d.max().item()}")
    timed_row(out, "gather_keyed_q15", float(d.max().item()),
              lambda: gather_cuda.bilinear_gather_keyed_q15(
                  eff, p1_s, inv_sl, inv_p=inv_p),
              lambda: gather_cuda.bilinear_gather_keyed_q15_plain(
                  eff, p1_s, inv_sl, inv_p=inv_p),
              8 * n + 8 * texels, 30 * n)

    # K12 at the same rows' padded coords (clamped as the draw's aux
    # contract has them): reads xs, ys (8 B a row) and the touched texels,
    # writes 2 values a row. Library: `grid_sample` (bilinear, zero
    # padding, unaligned corners) on the content coords, normalised first.
    x, y = p1_coords(p1_s, inv_p, h, w)
    xs, ys = x + PAD_LO_W, y + PAD_LO_H
    k12 = gather_cuda.bilinear_gather_keyed(eff, xs, ys)
    err = close("gather_keyed", [k12],
                [gather_cuda.bilinear_gather_keyed_plain(eff, xs, ys)])
    norm = torch.stack([(xs - PAD_LO_W) / w * 2.0 - 1.0,
                        (ys - PAD_LO_H) / h * 2.0 - 1.0], dim=-1)[None, None]

    def library():
        return torch.nn.functional.grid_sample(
            eff[None], norm, mode="bilinear", padding_mode="zeros",
            align_corners=False)

    lib_err = (library()[0, :, 0] - k12).abs().max().item()
    if lib_err > 1e-3 * eff.abs().max().item():
        fail(f"gather_keyed vs grid_sample: max |d| {lib_err:.3e}")
    print(f"  (grid_sample against K12: max |d| {lib_err:.3e})")
    timed_row(out, "gather_keyed", err,
              lambda: gather_cuda.bilinear_gather_keyed(eff, xs, ys),
              lambda: gather_cuda.bilinear_gather_keyed_plain(eff, xs, ys),
              16 * n + 8 * touched_texels(x, y, h, w), 20 * n,
              library_fn=library)
    against_library("gather_keyed",
                    lambda: gather_cuda.bilinear_gather_keyed(eff, xs, ys),
                    library)

    # The textured resident frame's variants at config 4: K1 reads p1,
    # vel, pos (8 B each), mapped (16 B), live, idx (4 B each) a row.
    n4, hw4 = 512 * 512, (720, 1280)
    check_variant_pack_splat("rgba", n4, hw4,
                             classic_streams(n4, hw4, sl, 4, exact_p0=False),
                             48, out)
    return out


def check_state(sim, label):
    for name in ("particles", "previous", "flow", "view", "force"):
        if getattr(sim, name) is None:
            continue
        if not torch.isfinite(getattr(sim, name)).all():
            fail(f"{label}: non-finite {name}")
    alive = ((sim.particles[0] > -9e5).sum().item())
    texels = (sim.flow[3] > 1e-3).sum().item()
    if alive == 0 or texels == 0:
        fail(f"{label}: {alive} alive particles, {texels} flow texels")
    return alive, texels


def by_id(sim):
    return sim.particles.cpu()[:, torch.argsort(sim.idx.cpu())]


def agree(cpu, gpu, label):
    """The card's state against the CPU's: particles and the carried force
    by identity atol 1e-4; grids by the reference's cross-path tolerance
    (1-px smoothed rtol 5e-2 / atol 2e-2, totals rtol 1e-3; float atomics
    reorder the sums)."""
    def smooth(img):
        k = torch.ones(1, 1, 3, 3) / 9.0
        return torch.nn.functional.conv2d(img[:, None], k, padding=1)[:, 0]

    err = (by_id(cpu.sim) - by_id(gpu.sim)).abs().max().item()
    if err > 1e-4:
        fail(f"{label} card vs CPU: particles differ by {err:.3e}")
    if (cpu.sim.force is None) != (gpu.sim.force is None):
        fail(f"{label} card vs CPU: a carried force on one side only")
    if cpu.sim.force is not None:
        order = [torch.argsort(e.sim.idx.cpu()) for e in (cpu, gpu)]
        err_f = (cpu.sim.force[:, order[0]]
                 - gpu.sim.force.cpu()[:, order[1]]).abs().max().item()
        if err_f > 1e-4:
            fail(f"{label} card vs CPU: forces differ by {err_f:.3e}")
    h, w = cpu.config.view_res
    for name in ("flow", "view"):
        a = getattr(cpu.sim, name).reshape(-1, h, w)
        b = getattr(gpu.sim, name).cpu().reshape(-1, h, w)
        if not torch.allclose(smooth(b), smooth(a), rtol=5e-2, atol=2e-2):
            fail(f"{label} card vs CPU: {name} differs")
        if not torch.allclose(b.sum(), a.sum(), rtol=1e-3):
            fail(f"{label} card vs CPU: {name} totals {b.sum()} vs "
                 f"{a.sum()}")
    return err


def spawned_pair(view_res, **cfg_kw):
    """A root-64 engine on the CPU and one on the card, from one spawn."""
    import tendrils_tpu_torch as tt
    from tendrils_tpu_torch import convert
    from tendrils_tpu_torch.models.configs import _backends
    from tendrils_tpu_torch.ops import spawn
    cfg = tt.EngineConfig(root_num=64, view_res=view_res, **_backends(),
                          **cfg_kw)
    cpu, gpu = (tt.Tendrils(cfg, device=dev).setup()
                for dev in ("cpu", "cuda"))
    cpu.spawn_shader(lambda p, e: spawn.ball(p, e._frag_xy, 0.6, 0.01))
    gpu.timer.tick()
    gpu.sim = convert.sim_from_numpy(convert.sim_to_numpy(cpu.sim), "cuda")
    return cpu, gpu


def agree_with_plain(**cfg_kw):
    """Config 2's frame: a small run on the card against the same run on
    the CPU (plain versions), 3 frames."""
    cpu, gpu = spawned_pair((1080, 1920), **cfg_kw)
    for _ in range(3):
        cpu.frame()
        gpu.frame()
    return agree(cpu, gpu, "1m-flow")


def agree_io_with_plain():
    """Config 4's frame: a small run (root 64, 720x1280) on the card
    against the same run on the CPU, 3 io frames with camera and pointers."""
    from tendrils_tpu_torch.feeds import IoFeed
    cpu, gpu = spawned_pair((720, 1280))
    feeds = [IoFeed(cpu), IoFeed(gpu)]
    for i in range(3):
        for feed in feeds:
            feed.frame(i)
    return agree(cpu, gpu, "optical-flow-driven")


def replay(eng):
    """K2's replay contract: the same config-2 frame twice from one
    converted state. The frame's carried force is K4's gather from the
    flow K3 resolves from K2's sums, decayed (a factor in [0, 1]) and
    interpolated (weights summing to 1), so its error is held to the flow
    velocity channels' bound."""
    from tendrils_tpu_torch import convert
    state, t0 = convert.sim_to_numpy(eng.sim), eng.timer.time
    runs = []
    for _ in range(2):
        eng.sim = convert.sim_from_numpy(state, "cuda")
        eng.timer.time = t0
        eng.frame()
        runs.append(eng.sim)
    torch.cuda.synchronize()
    a, b = runs
    err_p = (by_id(a) - by_id(b)).abs().max().item()
    if err_p > 1e-4:
        fail(f"replay: particles differ by {err_p:.3e}")
    grids = {name: within_channel_max(f"replay {name}",
                                      getattr(a, name).reshape(4, -1),
                                      getattr(b, name).reshape(4, -1))
             for name in ("flow", "view")}
    force = [s.force.cpu()[:, torch.argsort(s.idx.cpu())] for s in runs]
    err_f = (force[0] - force[1]).abs().amax(dim=1)
    scale = a.flow[:2].abs().reshape(2, -1).amax(dim=1).cpu()
    if not (err_f <= 1e-5 * scale).all():
        fail(f"replay: force max |d| {err_f.tolist()} vs flow max "
             f"{scale.tolist()}")
    grids["force"] = err_f.max().item()
    return err_p, grids


def run_config2():
    """Phase 4: config 2 through the entry points; returns the engine, its
    final state, the launch counts and the timed result."""
    import tendrils_tpu_torch as tt
    from tendrils_tpu_torch import models
    from tendrils_tpu_torch.ops import cuda_lib
    eng = models.build("1m-flow")
    cuda_lib.reset_counts()
    eng.frame()
    eng.frame()
    eng.sim.force = None  # run_headless seeds it (K5), as bench.py's scan
    sim = tt.run_headless(eng.sim, eng.params(), eng.config, eng._view_size,
                          eng.timer.time, DT, STEPS, targets_live=False)
    torch.cuda.synchronize()
    launches = dict(cuda_lib.launches)
    plain = dict(cuda_lib.plain_calls)
    missing = [k for k in CONFIG2_PATH if launches.get(k, 0) == 0]
    if missing or any(plain.values()):
        fail(f"1m-flow launches {launches}, plain calls {plain}")
    alive, texels = check_state(sim, "1m-flow")

    times = []
    t_sim = eng.timer.time + STEPS * DT
    for _ in range(3):
        sim.force = None
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sim = tt.run_headless(sim, eng.params(), eng.config, eng._view_size,
                              t_sim, DT, STEPS, targets_live=False)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        t_sim += STEPS * DT
    check_state(sim, "1m-flow timed")
    eng.sim, eng.timer.time = sim, t_sim
    sec = statistics.median(times) / STEPS
    err = agree_with_plain()
    runs = ", ".join(f"{t / STEPS * 1e3:.3f}" for t in times)
    print(f"[4] 1m-flow: 2 frames + {STEPS} headless steps, launches "
          f"{launches}, no plain calls; {alive} alive, {texels} flow texels; "
          f"{sec * 1e3:.3f} ms/frame, {eng.config.n / sec:.0f} "
          f"particle-steps/s (median of 3 x {STEPS} steps: {runs} ms/frame); "
          f"card vs CPU particles max |d| {err:.2e}")
    return eng, launches


def run_config4():
    """Phase 6: config 4 through the entry points; returns the launch
    counts."""
    from tendrils_tpu_torch import models
    from tendrils_tpu_torch.feeds import IoFeed
    from tendrils_tpu_torch.ops import cuda_lib
    eng = models.build("optical-flow-driven")
    feed = IoFeed(eng)
    cuda_lib.reset_counts()
    feed.frame(0)
    feed.frame(1)
    torch.cuda.synchronize()
    times = []
    i = 2
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(IO_FRAMES):
            feed.frame(i)
            i += 1
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    launches = dict(cuda_lib.launches)
    plain = dict(cuda_lib.plain_calls)
    frames = 2 + 3 * IO_FRAMES
    missing = [k for k in CONFIG4_PATH if launches.get(k, 0) == 0]
    if missing or any(plain.values()) or launches.get("gather_reconstruct") \
            or launches["reconstruct_resident"] != frames \
            or launches["gather_keyed_p1"] != frames:
        fail(f"optical-flow-driven launches {launches}, plain calls {plain}")
    alive, texels = check_state(eng.sim, "optical-flow-driven")
    sec = statistics.median(times) / IO_FRAMES
    err = agree_io_with_plain()
    runs = ", ".join(f"{t / IO_FRAMES * 1e3:.3f}" for t in times)
    print(f"[6] optical-flow-driven: {frames} step_draw_io frames (480x640 "
          f"u8 camera upload + 4 pointer lines each), launches {launches}, "
          f"no plain calls; {alive} alive, {texels} flow texels; "
          f"{sec * 1e3:.3f} ms/frame, {eng.config.n / sec:.0f} "
          f"particle-steps/s (median of 3 x {IO_FRAMES} frames: {runs} "
          f"ms/frame); card vs CPU particles max |d| {err:.2e}")
    return launches


def check_launches(label, frames, per_frame, launches, plain):
    """Every kernel of `per_frame` launched `frames` x its count, no other
    kernel of the draw's tail, and no plain version."""
    for k in ("pack", "splat", "pack_p0_rgba", "splat_p0_rgba", "pack_rgba",
              "splat_rgba", "resolve", "gather_keyed_q15",
              "gather_reconstruct", "reconstruct_resident", "gather_keyed_p1",
              "splat_points", "pack_g3", "pack_p0_rgba_g2", "reorder_compact",
              "reorder_apply"):
        if launches.get(k, 0) != frames * per_frame.get(k, 0):
            fail(f"{label}: {k} launched {launches.get(k, 0)} times, want "
                 f"{frames * per_frame.get(k, 0)} (launches {launches})")
    if any(plain.values()):
        fail(f"{label}: plain calls {plain}")


def run_path_a():
    """Phase 7: the classic carried-force frame at config 2 through the
    entry points; returns the launch counts of its main-path run."""
    import tendrils_tpu_torch as tt
    from tendrils_tpu_torch import models
    from tendrils_tpu_torch.ops import cuda_lib
    eng = models.build("1m-flow")
    eng.config = dataclasses.replace(eng.config, resident_stream=False)
    cuda_lib.reset_counts()
    eng.frame()
    eng.frame()
    sim = tt.run_headless(eng.sim, eng.params(), eng.config, eng._view_size,
                          eng.timer.time, DT, STEPS, targets_live=False)
    torch.cuda.synchronize()
    launches = dict(cuda_lib.launches)
    check_launches("classic 1m-flow", 2 + STEPS,
                   dict(PATH_A, bilinear_gather=0), launches,
                   dict(cuda_lib.plain_calls))
    if launches.get("bilinear_gather") != 1:  # the first frame's step
        fail(f"classic 1m-flow: launches {launches}")
    if not torch.equal(sim.idx.cpu(), torch.arange(eng.config.n,
                                                   dtype=torch.int32)):
        fail("classic 1m-flow: the rows changed order")
    alive, texels = check_state(sim, "classic 1m-flow")
    times = []
    t_sim = eng.timer.time + STEPS * DT
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sim = tt.run_headless(sim, eng.params(), eng.config, eng._view_size,
                              t_sim, DT, STEPS, targets_live=False)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        t_sim += STEPS * DT
    check_state(sim, "classic 1m-flow timed")
    sec = statistics.median(times) / STEPS
    err = agree_with_plain(resident_stream=False)
    runs = ", ".join(f"{t / STEPS * 1e3:.3f}" for t in times)
    print(f"[7] classic 1m-flow (resident_stream=False): 2 frames + {STEPS} "
          f"headless steps, launches {launches}, no plain calls; {alive} "
          f"alive, {texels} flow texels; {sec * 1e3:.3f} ms/frame, "
          f"{eng.config.n / sec:.0f} particle-steps/s (median of 3 x "
          f"{STEPS} steps: {runs} ms/frame); card vs CPU particles max |d| "
          f"{err:.2e}")
    return launches


def timed_frames(fn, frames):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(frames):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / frames


def agree_paths_b_c():
    """Paths B and C at root 64, 720x1280, on the card against the CPU:
    3 running io frames with the colour maps, then, paused, 2 io frames
    and 2 `frame()` calls, each compared."""
    from tendrils_tpu_torch.feeds import IoFeed
    cpu, gpu = spawned_pair((720, 1280))
    feeds = [IoFeed(cpu, color_maps=True), IoFeed(gpu, color_maps=True)]
    errs = []
    for i in range(3):
        for feed in feeds:
            feed.frame(i)
    errs.append(agree(cpu, gpu, "optical-flow-driven, colour maps"))
    for eng in (cpu, gpu):
        eng.timer.paused = True
    for i in range(3, 5):
        for feed in feeds:
            feed.frame(i)
    errs.append(agree(cpu, gpu, "paused io frame"))
    for _ in range(2):
        cpu.frame()
        gpu.frame()
    errs.append(agree(cpu, gpu, "paused frame()"))
    return errs


def run_paths_b_c():
    """Phase 8: config 4 with the demo's colour maps, running (path C),
    paused io frames (path C paused) and paused `frame()` calls (path B);
    returns the launch counts of the three runs together."""
    from tendrils_tpu_torch import models
    from tendrils_tpu_torch.feeds import IoFeed
    from tendrils_tpu_torch.ops import cuda_lib
    eng = models.build("optical-flow-driven")
    feed = IoFeed(eng, color_maps=True)
    total = {}

    def tally(label, frames, per_frame):
        torch.cuda.synchronize()
        launches = dict(cuda_lib.launches)
        check_launches(label, frames, per_frame, launches,
                       dict(cuda_lib.plain_calls))
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        return launches

    cuda_lib.reset_counts()
    feed.frame(0)
    feed.frame(1)
    frames = itertools.count(2)
    times = [timed_frames(lambda: feed.frame(next(frames)), IO_FRAMES)
             for _ in range(3)]
    launches_c = tally("colour-mapped io frame", 2 + 3 * IO_FRAMES,
                       dict(PATH_C_RUNNING, bilinear_gather=0))
    if eng.config.color_map_res != (480, 640):
        fail(f"colour map {eng.config.color_map_res}, want (480, 640)")
    alive, texels = check_state(eng.sim, "colour-mapped io frame")

    eng.timer.paused = True
    cuda_lib.reset_counts()
    sec_paused_io = timed_frames(lambda: feed.frame(next(frames)), IO_FRAMES)
    tally("paused io frame", IO_FRAMES, PATH_C_PAUSED)
    if eng.sim.force is not None:
        fail("paused io frame: a carried force")
    cuda_lib.reset_counts()
    sec_paused = timed_frames(eng.frame, IO_FRAMES)
    tally("paused frame()", IO_FRAMES, PATH_B)
    check_state(eng.sim, "paused frame()")
    if eng.sim.force is None:
        fail("paused frame(): no carried force")
    errs = agree_paths_b_c()
    sec = statistics.median(times)
    runs = ", ".join(f"{t * 1e3:.3f}" for t in times)
    print(f"[8] optical-flow-driven with 3 colour maps (2 x f32[4, 1, 512] "
          f"audio + the 480x640 camera grid): {2 + 3 * IO_FRAMES} running io "
          f"frames, launches {launches_c}; {alive} alive, {texels} flow "
          f"texels; {sec * 1e3:.3f} ms/frame, {eng.config.n / sec:.0f} "
          f"particle-steps/s (median of 3 x {IO_FRAMES}: {runs} ms/frame); "
          f"paused: {IO_FRAMES} io frames {sec_paused_io * 1e3:.3f} ms/frame, "
          f"{IO_FRAMES} frame() calls (the paused draw + K7) "
          f"{sec_paused * 1e3:.3f} ms/frame; no plain calls; card vs CPU "
          f"particles max |d| running {errs[0]:.2e}, paused io "
          f"{errs[1]:.2e}, paused frame() {errs[2]:.2e}")
    return total


def capture_frame(eng, frames, *targets):
    """Run `frames` frames of `eng`, then one more whose calls of each
    `(owner, name)` of `targets` are recorded, the last call of each:
    `{name: (args, kwargs)}`, tensors cloned (the script wraps them in
    place for that frame and restores them; the package never does)."""
    for _ in range(frames):
        eng.frame()
    got = {}

    def clone(x):
        return x.clone() if isinstance(x, torch.Tensor) else x

    def wrap(name, fn):
        def run(*a, **kw):
            got[name] = ([clone(x) for x in a],
                         {k: clone(v) for k, v in kw.items()})
            return fn(*a, **kw)
        return run

    origs = [(owner, name, getattr(owner, name)) for owner, name in targets]
    for owner, name, fn in origs:
        setattr(owner, name, wrap(name, fn))
    try:
        eng.frame()
    finally:
        for owner, name, fn in origs:
            setattr(owner, name, fn)
    torch.cuda.synchronize()
    return got


def capture_merge_inputs(eng, frames=3):
    """The merge reorder's and K2's inputs on a real resident frame: the
    engine (merge on) runs `frames` frames, then one more whose
    `reorder_cuda.merge_reorder` and `draw_cuda.splat` calls are recorded
    (`capture_frame`). Returns `(merge inputs, splat (args, kwargs))`."""
    from tendrils_tpu_torch.ops import draw_cuda, reorder_cuda
    eng.config = dataclasses.replace(eng.config, merge_reorder=True)
    eng.reseed_derived()
    got = capture_frame(eng, frames, (reorder_cuda, "merge_reorder"),
                        (draw_cuda, "splat"))
    (key, prev_key, prev_hist), kw = got["merge_reorder"]
    return (dict(key=key, prev_key=prev_key, prev_hist=prev_hist, **kw),
            got["splat"])


def check_reorder_at(label, inp, out=None):
    """K10 and K11 bit for bit against their plain versions on one frame's
    merge inputs, and on the all-churn case of the engine's MAXKEY seed
    (`ok` false on both); timed with the merge as a whole, the flat sort
    it replaces and (K10) a boolean-mask selection. With `out`, records
    the kernels' rows there. Returns the churned share."""
    from tendrils_tpu_torch.ops import reorder_cuda as ro
    key, prev, hist = inp["key"], inp["prev_key"], inp["prev_hist"]
    kw = dict(n_tiles=inp["n_tiles"], idx_bits=inp["idx_bits"])
    n, cap, nb, t = key.numel(), ro.capacity(key.numel()), \
        key.numel() // ro.SB, kw["n_tiles"]
    dev = key.device

    def same(name, got, want):
        for i, (a, b) in enumerate(zip(got, want)):
            if not torch.equal(a, b):
                fail(f"{name} ({label}): output {i}: "
                     f"{(a != b).sum().item()} values differ")

    k_total, base_b = ro.churn_blocks(key, prev)
    k = int(k_total)
    same("reorder_compact", ro.compact(key, prev, base_b),
         ro.compact_plain(key, prev, base_b))
    args, _ = ro.merge_plan(key, prev, hist, **kw)
    k11 = ro.merge_apply(*args, idx_bits=kw["idx_bits"])
    same("reorder_apply", k11, ro.merge_apply_plain(
        *args, idx_bits=kw["idx_bits"]))
    ok = ro.merge_reorder(key, prev, hist, **kw)[0]
    if not bool(ok):
        fail(f"merge_reorder ({label}): ok false on a steady frame "
             f"({k} of {n} rows churned)")
    order = torch.sort(key)[0]
    if not torch.equal(k11[0] >> kw["idx_bits"], order >> kw["idx_bits"]):
        fail(f"merge_reorder ({label}): not sorted by tile")

    # The engine's seed: every row churned, over the capacity.
    seed = torch.full_like(prev, ro.MAXKEY)
    zeros = torch.zeros_like(hist)
    s_base = ro.churn_blocks(key, seed)[1]
    same("reorder_compact (all churned)", ro.compact(key, seed, s_base),
         ro.compact_plain(key, seed, s_base))
    s_args, _ = ro.merge_plan(key, seed, zeros, **kw)
    s_counts = [f(*s_args, idx_bits=kw["idx_bits"])[2]
                for f in (ro.merge_apply, ro.merge_apply_plain)]
    same("reorder_apply counts (all churned)", s_counts[:1], s_counts[1:])
    if bool(ro.merge_reorder(key, seed, zeros, **kw)[0]):
        fail(f"merge_reorder ({label}): ok true with every row churned")

    ar = torch.arange(n, dtype=torch.int32, device=dev)

    def mask_select():
        m = key != prev
        return key[m], prev[m], ar[m]

    timed = {label_: time_calls(fn, reps)[0] for label_, fn, reps in (
        ("merge", lambda: ro.merge_reorder(key, prev, hist, **kw), REPS),
        ("sort", lambda: torch.sort(key), REPS))}
    print(f"  {label}: {k} of {n} rows churned ({k / n:.2%}); "
          f"reorder_compact and reorder_apply bit-exact, the all-churn seed "
          f"ok false on both; device ms of the whole merge_reorder (K10, "
          f"censuses, C sort, K11) {timed['merge']:.4f}, of the flat "
          f"torch.sort of the same keys {timed['sort']:.4f}")
    if out is not None:
        timed_row(out, "reorder_compact", 0.0,
                  lambda: ro.compact(key, prev, base_b),
                  lambda: ro.compact_plain(key, prev, base_b),
                  8 * n + 4 * nb + 12 * cap, 8 * n, library_fn=mask_select)
        timed_row(out, "reorder_apply", 0.0,
                  lambda: ro.merge_apply(*args, idx_bits=kw["idx_bits"]),
                  lambda: ro.merge_apply_plain(*args,
                                               idx_bits=kw["idx_bits"]),
                  16 * n + 8 * k + 8 * t + 8 * nb, 8 * n + 4 * k)
    return k / n


def check_gather_mode_packs(out):
    """K1 in gather mode 3 (the resident stream beyond 2^20 rows: key_recon,
    `tile << 19 | id_lo`) and mode 2 (the non-resident draw: exact p0 and
    rgba8, the tile alone) at config-3 shapes, bit for bit."""
    from tendrils_tpu_torch.ops import draw_cuda
    n, hw = 1 << 22, (1080, 1920)
    s = sorted_streams(n, hw, 0.01, 5)
    kw = dict(grid_hw=hw, pscale=s["pscale"], gather=3)
    rows = [("pack_g3", s["pack_args"], kw, 24, 12)]
    c = classic_streams(n, hw, 0.01, 6)
    rows.append(("pack_p0_rgba_g2", c["pack_args"],
                 dict(c["pack_kw"], gather=2), 52, 20))
    for name, args, kw, in_b, out_b in rows:
        got = draw_cuda.pack(*args, **kw)
        want = draw_cuda.pack_plain(*args, **kw)
        for field, a, b in zip(("keym", "p1", "vl", "p0", "rgba"), got,
                               want):
            if (a is None) != (b is None) or (a is not None
                                              and not torch.equal(a, b)):
                fail(f"{name} {field}: words differ")
        print(f"  {name}: bit-exact")
        timed_row(out, name, 0.0, lambda: draw_cuda.pack(*args, **kw),
                  lambda: draw_cuda.pack_plain(*args, **kw),
                  (in_b + out_b) * n + 128, 60 * n)


def check_merge_kernels():
    """Phase 3's merge part: K10 and K11 on the merge inputs of real
    resident frames at config 3 (recorded) and config 2 (printed), K2 on
    the config-3 frame's sorted stream, and the K1 mode-2/3 variants."""
    from tendrils_tpu_torch import models
    out = {}
    for name, label in (("4m-respawn-stress", "config 3, 4,194,304 rows, "
                         "gather mode 3"),
                        ("1m-flow", "config 2, 1,048,576 rows, gather "
                         "mode 1")):
        inp, (args, kw) = capture_merge_inputs(models.build(name))
        check_reorder_at(label, inp, out if name.startswith("4m") else None)
        del inp
        if name.startswith("4m"):
            merged = not torch.equal(args[1], torch.sort(args[1])[0])
            check_splat_stream(
                "sorted stream of a real config-3 frame (keys in "
                + ("the merge's order" if merged else "the flat sort's")
                + ")", *args, **kw)
        del args, kw
    check_gather_mode_packs(out)
    return out


def check_splat_streams():
    """Phase 3's K2 part beyond the seeded streams: the sorted stream of a
    real config-2 frame after 30 frames (flow feedback has clustered the
    particles), and a classic p0 stream at config 2 in gather mode 2 with
    a twentieth of its p0 anywhere on the grid (segments across tiles:
    strays)."""
    from tendrils_tpu_torch import models
    from tendrils_tpu_torch.ops import draw_cuda
    args, kw = capture_frame(models.build("1m-flow"), 30,
                             (draw_cuda, "splat"))["splat"]
    check_splat_stream("sorted stream of a real config-2 frame after 30 "
                       "frames", *args, **kw, exact=True)
    del args, kw
    c = classic_streams(1 << 20, (1080, 1920), 0.01, 10, jump=0.05,
                        gather=2)
    keym_s, p1_s, vl_s, p0_s, rgba_s = c["sorted"]
    _, strays = check_splat_stream(
        "classic p0 stream with long segments", c["scal"], keym_s, p1_s,
        vl_s, idx_bits=c["bits"], samples=2, grid_hw=(1080, 1920),
        pscale=c["pscale"], p0=p0_s, rgba=rgba_s)
    if strays == 0:
        fail("K2: the long-segment stream has no strays")


def record_merges(run):
    """`run()` with each merge frame's churned rows and `ok` read back (the
    script wraps `reorder_cuda.merge_reorder` in place for the run and
    restores it; the package never does). Returns `(run's result, [(churned
    rows, rows, ok), ...])`."""
    from tendrils_tpu_torch.ops import reorder_cuda
    log, orig = [], reorder_cuda.merge_reorder

    def record(key, prev_key, prev_hist, **kw):
        out = orig(key, prev_key, prev_hist, **kw)
        log.append((int((key != prev_key).sum()), key.numel(), bool(out[0])))
        return out

    reorder_cuda.merge_reorder = record
    try:
        return run(), log
    finally:
        reorder_cuda.merge_reorder = orig


def check_merge_log(label, log, need_merge):
    """Every frame merged exactly when its churn fit the n // 8 capacity
    (with a valid carry the per-block counts always hold), and with
    `need_merge` at least one did; returns a summary."""
    bad = [(k, n, ok) for k, n, ok in log if ok != (k <= n // 8)]
    if bad:
        fail(f"{label}: merge ok disagrees with the capacity guard on "
             f"{len(bad)} frames (churned, rows, ok): {bad[:4]}")
    merged = sum(ok for *_, ok in log)
    if need_merge and not merged:
        fail(f"{label}: no frame merged")
    shares = sorted(k / n for k, n, _ in log[1:])
    return (f"churn after the first frame min {shares[0]:.2%}, median "
            f"{statistics.median(shares):.2%}, max {shares[-1]:.2%} "
            f"(capacity 12.5%); {merged} of {len(log)} frames merged, each "
            "exactly when its churn fit")


def carry_ok(sim, cfg, label):
    """The state (alive, finite), `idx` a permutation and, with the merge
    on, the carry's invariants: `sort_key` tile-sorted with the rows' ids
    in its low bits, `sort_hist` its exact census."""
    from tendrils_tpu_torch.ops import draw_cuda
    alive, texels = check_state(sim, label)
    n = cfg.n
    if not torch.equal(torch.sort(sim.idx)[0],
                       torch.arange(n, dtype=torch.int32, device="cuda")):
        fail(f"{label}: idx is not a permutation")
    if sim.sort_key is None:
        return alive, texels
    nt = draw_cuda.seg_tile_count(cfg.view_res)
    bits = draw_cuda._idx_bits(draw_cuda.gather_mode(
        n, nt, ids=True, resident=True, idx_bound=n))
    tiles = sim.sort_key >> bits
    if (tiles[1:] < tiles[:-1]).any():
        fail(f"{label}: sort_key is not tile-sorted")
    mask = (1 << bits) - 1
    if not torch.equal(sim.sort_key & mask, sim.idx & mask):
        fail(f"{label}: sort_key does not follow the rows")
    hist = torch.zeros(nt, dtype=torch.int64, device="cuda").index_add_(
        0, tiles.long(), torch.ones_like(tiles, dtype=torch.int64))
    if not torch.equal(sim.sort_hist.long(), hist):
        fail(f"{label}: sort_hist is not the census of sort_key")
    return alive, texels


def with_merge(eng, merge):
    """`eng` with `merge_reorder` set; its carry seeded or dropped."""
    eng.config = dataclasses.replace(eng.config, merge_reorder=merge)
    eng.reseed_derived()
    return eng


def headless(eng, sim, steps, t_sim):
    import tendrils_tpu_torch as tt
    return tt.run_headless(sim, eng.params(), eng.config, eng._view_size,
                           t_sim, DT, steps, targets_live=False)


def run_merge_config2():
    """Phase 9a: config 2 with the merge on: two facade frames and STEPS
    headless steps with the launch and event counts and each frame's churn
    (`record_merges`); then 3 timed runs of STEPS, merge on and off from
    the same state in turns; then merge on against off after 5 frames from
    one state, by identity."""
    from tendrils_tpu_torch import models
    from tendrils_tpu_torch.ops import cuda_lib
    eng = with_merge(models.build("1m-flow"), True)
    cuda_lib.reset_counts()

    def run():
        eng.frame()
        eng.frame()
        eng.sim.force = None
        return headless(eng, eng.sim, STEPS, eng.timer.time)

    sim, log = record_merges(run)
    torch.cuda.synchronize()
    launches, events = dict(cuda_lib.launches), dict(cuda_lib.events)
    frames = 2 + STEPS
    check_launches("1m-flow merge", frames, dict(MERGE_C2, bilinear_gather=0),
                   launches, dict(cuda_lib.plain_calls))
    if launches.get("bilinear_gather") != 2 \
            or launches.get("reorder_compact") != frames \
            or launches.get("reorder_apply") != frames:
        fail(f"1m-flow merge: launches {launches}")
    merged, fell = events.get("reorder_merged", 0), \
        events.get("reorder_fallback", 0)
    if merged + fell != frames or fell < 1 or log[0][2] \
            or len(log) != frames:
        fail(f"1m-flow merge: {merged} merged, {fell} fallbacks in "
             f"{frames} frames (the first must fall back)")
    churn = check_merge_log("1m-flow merge", log, need_merge=True)
    alive, texels = carry_ok(sim, eng.config, "1m-flow merge")

    t_sim = eng.timer.time + STEPS * DT
    times = {True: [], False: []}
    for rep in range(3):
        runs = {}
        for merge in ((True, False) if rep % 2 == 0 else (False, True)):
            start = dataclasses.replace(sim, force=None)
            with_merge(eng, merge)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            runs[merge] = headless(eng, start, STEPS, t_sim)
            torch.cuda.synchronize()
            times[merge].append((time.perf_counter() - t0) / STEPS)
        sim = runs[True]
        t_sim += STEPS * DT
    carry_ok(sim, eng.config, "1m-flow merge timed")

    # Merge on against off after 5 frames from one state, by identity.
    ends = {}
    for merge in (True, False):
        start = dataclasses.replace(sim, force=None)
        ends[merge] = headless(with_merge(eng, merge), start, 5, t_sim)
    pa, pb = by_id(ends[True]), by_id(ends[False])
    d = (pa - pb).abs()
    share = (d > 5e-5).float().mean().item()
    if d.max().item() > 1e-3 or share >= 0.01:
        fail(f"1m-flow merge on vs off: max |d| {d.max().item():.3e}, "
             f"{share:.3%} of values beyond 5e-5")
    med = {m: statistics.median(v) for m, v in times.items()}
    print(f"[9] 1m-flow merge on: 2 frames + {STEPS} headless steps, "
          f"launches {launches}, no plain calls, {merged} merged, {fell} "
          f"fallback; {churn}; {alive} alive, {texels} flow texels; carry "
          f"valid. "
          f"ms/frame merge on {med[True] * 1e3:.3f} (runs "
          f"{', '.join(f'{t * 1e3:.3f}' for t in times[True])}), off "
          f"{med[False] * 1e3:.3f} (runs "
          f"{', '.join(f'{t * 1e3:.3f}' for t in times[False])}), median "
          f"of 3 x {STEPS} in turns; on vs off after 5 steps by identity: "
          f"max |d| {d.max().item():.3e}, {share:.4%} beyond 5e-5")
    return launches


def ball(eng):
    from tendrils_tpu_torch.ops import spawn
    eng.spawn_shader(lambda p, e: spawn.ball(p, e._frag_xy, 0.6, 0.01))


def run_merge_config3():
    """Phase 9b: config 3 (`bench.py:_bench_3`'s cadence: a ball respawn,
    then 10 headless steps), merge on and off: one warm segment, then 3
    timed segments; each respawn's first frame must fall back."""
    from tendrils_tpu_torch import models
    from tendrils_tpu_torch.ops import cuda_lib
    eng = models.build("4m-respawn-stress")
    total, med = {}, {}
    for merge in (True, False):
        with_merge(eng, merge)
        ball(eng)
        eng.sim, log = record_merges(
            lambda: headless(eng, eng.sim, SEG, eng.timer.time))
        eng.timer.time += SEG * DT
        warm = check_merge_log("4m-respawn-stress warm segment", log,
                               need_merge=False) if merge else "merge off"
        cuda_lib.reset_counts()
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            # The events count on the host as each frame reads its ok.
            fell = cuda_lib.events.get("reorder_fallback", 0)
            ball(eng)
            eng.sim = headless(eng, eng.sim, 1, eng.timer.time)
            if merge and cuda_lib.events.get("reorder_fallback", 0) \
                    != fell + 1:
                fail("4m-respawn-stress: a respawn's first frame did not "
                     f"fall back (events {dict(cuda_lib.events)})")
            eng.sim = headless(eng, eng.sim, SEG - 1, eng.timer.time + DT)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) / SEG)
            eng.timer.time += SEG * DT
        launches, events = dict(cuda_lib.launches), dict(cuda_lib.events)
        frames = 3 * SEG
        label = f"4m-respawn-stress merge {'on' if merge else 'off'}"
        per = dict(MERGE_C2 if merge else CONFIG3_OFF, bilinear_gather=0)
        per["pack_g3"] = per.pop("pack")
        check_launches(label, frames, per, launches,
                       dict(cuda_lib.plain_calls))
        if launches.get("bilinear_gather") != 3:
            fail(f"{label}: launches {launches}")
        if merge and sum(events.values()) != frames or not merge and events:
            fail(f"{label}: events {events}")
        alive, texels = carry_ok(eng.sim, eng.config, label)
        med[merge] = statistics.median(times)
        print(f"[9] {label}: 3 x (ball respawn + {SEG} headless steps) "
              f"after a warm one ({warm}), launches {launches}, events "
              f"{events}, no plain calls; {alive} alive, {texels} flow "
              f"texels; "
              f"{med[merge] * 1e3:.3f} ms/frame (segments "
              f"{', '.join(f'{t * 1e3:.3f}' for t in times)}), "
              f"{eng.config.n / med[merge]:.0f} particle-steps/s")
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
    return eng, total


def run_config5_and_mode2(eng3):
    """Phase 10: config 5 headless, merge on and off (2 warm steps, 3 timed
    runs of SEG steps each); then at config 3 one classic frame and one
    paused `frame()` (gather mode 2, K7)."""
    from tendrils_tpu_torch import models
    from tendrils_tpu_torch.ops import cuda_lib
    total = {}

    def add(launches):
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v

    eng3.config = dataclasses.replace(eng3.config, resident_stream=False)
    eng3.reseed_derived()
    cuda_lib.reset_counts()
    eng3.frame()
    torch.cuda.synchronize()
    add(dict(cuda_lib.launches))
    check_launches("4m-respawn-stress classic", 1, CLASSIC_G2,
                   dict(cuda_lib.launches), dict(cuda_lib.plain_calls))
    carry_ok(eng3.sim, eng3.config, "4m-respawn-stress classic")
    if eng3.sim.force is None:
        fail("4m-respawn-stress classic: no carried force")
    eng3.timer.paused = True
    cuda_lib.reset_counts()
    eng3.frame()
    torch.cuda.synchronize()
    add(dict(cuda_lib.launches))
    check_launches("4m-respawn-stress paused frame()", 1, PAUSED_G2,
                   dict(cuda_lib.launches), dict(cuda_lib.plain_calls))
    carry_ok(eng3.sim, eng3.config, "4m-respawn-stress paused frame()")
    print("[10] 4m-respawn-stress, gather mode 2: one classic frame "
          f"({CLASSIC_G2}) and one paused frame() ({PAUSED_G2}), no plain "
          "calls, state valid")

    eng = models.build("16m-live-show")
    med = {}
    for merge in (True, False):
        with_merge(eng, merge)
        eng.sim.force = None
        cuda_lib.reset_counts()
        sim = headless(eng, eng.sim, 2, eng.timer.time)
        t_sim = eng.timer.time + 2 * DT
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sim = headless(eng, sim, SEG, t_sim)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) / SEG)
            t_sim += SEG * DT
        eng.sim, eng.timer.time = sim, t_sim
        launches, events = dict(cuda_lib.launches), dict(cuda_lib.events)
        frames = 2 + 3 * SEG
        label = f"16m-live-show merge {'on' if merge else 'off'}"
        per = dict(MERGE_C2 if merge else CONFIG3_OFF, bilinear_gather=0)
        per["pack_g3"] = per.pop("pack")
        check_launches(label, frames, per, launches,
                       dict(cuda_lib.plain_calls))
        if launches.get("bilinear_gather") != 1:
            fail(f"{label}: launches {launches}")
        if merge and (sum(events.values()) != frames
                      or events.get("reorder_fallback", 0) < 1) \
                or not merge and events:
            fail(f"{label}: events {events}")
        alive, texels = carry_ok(sim, eng.config, label)
        med[merge] = statistics.median(times)
        add(launches)
        print(f"[10] {label}: {frames} headless steps, launches {launches}, "
              f"events {events}, no plain calls; {alive} alive, {texels} "
              f"flow texels; {med[merge] * 1e3:.3f} ms/frame (3 x {SEG}: "
              f"{', '.join(f'{t * 1e3:.3f}' for t in times)}), "
              f"{eng.config.n / med[merge]:.0f} particle-steps/s")
    return total


def main():
    t_start = time.perf_counter()
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=False).stdout.strip().splitlines()
    except OSError as e:
        smi = [f"nvidia-smi: {e}"]
    card = smi[0] if smi else "nvidia-smi: no output"
    print(f"[1] card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")

    from tendrils_tpu_torch.ops import cuda_lib, draw_cuda
    if "jax" in sys.modules:
        fail("the port imported jax")
    if draw_cuda.SPLAT_LAUNCHES != K2:
        fail(f"K2 launches {draw_cuda.SPLAT_LAUNCHES} kernels a call, the "
             f"path tables count {K2}")

    t0 = time.perf_counter()
    cuda_lib.library()
    built = cuda_lib.build_seconds
    release = subprocess.run([cuda_lib._nvcc(), "--version"],
                             capture_output=True, text=True).stdout
    print(f"[2] kernels built in {time.perf_counter() - t0:.1f} s "
          f"(nvcc {'cached' if built is None else f'{built:.1f} s'}; "
          f"{release.strip().splitlines()[-1]})")

    print("[3] kernels vs plain versions at config-2 shapes:")
    checks = check_config2_kernels()
    print("[3] kernels vs plain versions at config-4 shapes:")
    checks.update(check_config4_kernels())
    print("[3] the K1/K2 variants with p0 and rgba8 streams, K7 and K12:")
    checks.update(check_slice3_kernels())
    print("[3] K2 on real and long-segment streams:")
    check_splat_streams()
    print("[3] the merge reorder (K10, K11) and K2 on real frames' inputs, "
          "and K1 in gather modes 3 and 2 at config-3 shapes:")
    checks.update(check_merge_kernels())

    eng, launches2 = run_config2()
    err_p, grids = replay(eng)
    print(f"[5] K2 replay of one config-2 frame: particles max |d| "
          f"{err_p:.3e} (atol 1e-4), flow max |d| {grids['flow']:.3e}, view "
          f"max |d| {grids['view']:.3e} (each channel <= 1e-5 x its max), "
          f"force max |d| {grids['force']:.3e} (<= 1e-5 x its flow "
          f"channel's max)")
    launches4 = run_config4()
    launches_a = run_path_a()
    launches_bc = run_paths_b_c()
    launches_m2 = run_merge_config2()
    eng3, launches_m3 = run_merge_config3()
    launches_big = run_config5_and_mode2(eng3)
    if "jax" in sys.modules:
        fail("the port imported jax")

    runs = (launches2, launches4, launches_a, launches_bc, launches_m2,
            launches_m3, launches_big)
    print(f"[11] every phase passed in {time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps({"kernels": [
        {"name": k, "route": "cuda", "source": src, "replaces": rep,
         "launches": sum(r.get(k, 0) for r in runs),
         **{key: checks[k][key] for key in (
             "max_abs_err", "ms", "call_ms", "plain_ms", "bound_ms",
             "bound_by", "library_ms")}}
        for k, (src, rep) in KERNELS.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
