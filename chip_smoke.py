"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints a line; any failure exits non-zero before the result):
  1. the card (nvidia-smi name and power limit), torch and CUDA versions;
  2. build the kernels (nvcc, one process per source, from
     tendrils_tpu_torch/csrc/);
  3. each kernel against its plain PyTorch version on the card, with its
     median time (CUDA events) beside the plain version's, its bound (the
     least time the card could take: bytes over 3.35 TB/s or operations
     over 67 TFLOP/s, the larger) and, where one PyTorch call computes the
     same function, that call's time: K1-K5 at the config-2 shapes
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
     and a small run on the card against the same run on the CPU.
The last three lines are the card, the per-kernel JSON and the result JSON.
"""

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
}
CONFIG2_PATH = ("pack", "splat", "resolve", "gather_reconstruct",
                "bilinear_gather")
CONFIG4_PATH = ("pack", "splat", "resolve", "bilinear_gather",
                "reconstruct_resident", "gather_keyed_p1", "splat_points")


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def median_ms(fn, reps):
    """Median device time of `fn` over `reps` calls (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


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
    _, perm = torch.sort(words[0])
    return dict(scal=scal, pack_args=pack_args, words=words, pscale=pscale,
                p1_s=words[1][perm], vl_s=words[2][perm],
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


def check_config2_kernels():
    """K1-K5 at config-2 shapes: {name: dict(max_abs_err, ms, plain_ms,
    bound_ms, bound_by, library_ms)}."""
    from tendrils_tpu_torch.ops import draw_cuda, gather_cuda
    from tendrils_tpu_torch.ops.tile_geom import pad_dims
    dev = torch.device("cuda")
    n, (h, w) = 1 << 20, (1080, 1920)
    hp, wp = pad_dims(h, w)
    sl, time_, fdecay = 0.01, 1000.0, 0.005
    s = sorted_streams(n, (h, w), sl, 0)
    pscale, scal = s["pscale"], s["scal"]
    out = {}

    def rec(name, err, ms, plain_ms, nbytes, ops, library_ms=None):
        b, by = bound(nbytes, ops)
        out[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                         bound_ms=b, bound_by=by, library_ms=library_ms)
        print(f"  {name}: max |d| {err:.3e}; {ms:.4f} ms (plain "
              f"{plain_ms:.4f} ms, bound {b:.4f} ms by {by}"
              + ("" if library_ms is None
                 else f", library {library_ms:.4f} ms") + ")")

    # K1: integer words, bit-exact. Reads p1_pix, vel, live, idx (24 B a
    # row) and the scalars, writes 3 words (12 B); ~60 operations a row.
    kw = dict(grid_hw=(h, w), pscale=pscale)
    got = s["words"]
    want = draw_cuda.pack_plain(*s["pack_args"], **kw)
    for name, a, b in zip(("keym", "p1", "vl"), got, want):
        if not torch.equal(a, b):
            fail(f"pack {name}: {(a != b).sum().item()} words differ")
    rec("pack", 0.0,
        median_ms(lambda: draw_cuda.pack(*s["pack_args"], **kw), 50),
        median_ms(lambda: draw_cuda.pack_plain(*s["pack_args"], **kw), 10),
        36 * n + 128, 60 * n)

    # K2 on the sorted stream. Reads p1, vl (8 B a row), writes the padded
    # 11-channel accumulator once; each live sample adds its box footprint
    # (a width-W box covers ceil(W) + 1 texels an axis but where it lies on
    # texel edges) at 3 operations a deposit, plus ~80 to derive it.
    p1_s, vl_s = s["p1_s"], s["vl_s"]
    kw = dict(samples=2, grid_hw=(h, w), pscale=pscale)
    acc = draw_cuda.splat(scal, p1_s, vl_s, **kw)
    ref = draw_cuda.splat_plain(scal, p1_s, vl_s, **kw)
    live_samples = 2 * ((vl_s >> 30) & 1).sum().item()
    deposits = live_samples * ((5 + 1) ** 2 * 5 + (1 + 1) ** 2 * 6)
    rec("splat", within_channel_max("splat", acc, ref),
        median_ms(lambda: draw_cuda.splat(scal, p1_s, vl_s, **kw), 20),
        median_ms(lambda: draw_cuda.splat_plain(scal, p1_s, vl_s, **kw), 3),
        8 * n + 11 * hp * wp * 4 + 128, 3 * deposits + 80 * live_samples)

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
        median_ms(lambda: draw_cuda.resolve(*args, want_eff=True), 50),
        median_ms(lambda: draw_cuda.resolve_plain(*args, want_eff=True), 10),
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
        median_ms(lambda: gather_cuda.gather_reconstruct_p1(*args, **kw), 50),
        median_ms(lambda: gather_cuda.gather_reconstruct_plain(*args, **kw),
                  10),
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
        median_ms(lambda: gather_cuda.bilinear_gather(eff, x, y), 50),
        median_ms(lambda: gather_cuda.bilinear_gather_plain(eff, x, y), 10),
        n * (8 + 2 * 4) + 2 * 4 * touched_texels(x, y, h, w), 20 * n,
        library_ms=median_ms(library, 50))
    print(f"  (grid_sample against K5: max |d| {lib_err:.3e})")
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

    def rec(name, err, ms, plain_ms, nbytes, ops, label=""):
        b, by = bound(nbytes, ops)
        out[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                         bound_ms=b, bound_by=by, library_ms=None)
        print(f"  {name}{label}: max |d| {err:.3e}; {ms:.4f} ms (plain "
              f"{plain_ms:.4f} ms, bound {b:.4f} ms by {by})")

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
        median_ms(lambda: draw_cuda.reconstruct_resident(*args), 50),
        median_ms(lambda: draw_cuda.reconstruct_resident_plain(*args), 10),
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
        median_ms(lambda: gather_cuda.bilinear_gather_keyed_p1(
            eff, s["p1_s"], inv_p=inv_p), 50),
        median_ms(lambda: gather_cuda.bilinear_gather_keyed_p1_plain(
            eff, s["p1_s"], inv_p=inv_p), 10),
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
            median_ms(lambda: splat_cuda.splat_accumulate(*sargs), 50),
            median_ms(lambda: splat_cuda.splat_accumulate_plain(*sargs), 10),
            x.numel() * 28 + 6 * h * w * 4, 12 * corners,
            label=f" ({label}, M = {x.numel()})")
    return out


def check_state(sim, label):
    for name in ("particles", "previous", "flow", "view", "force"):
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
    """The card's state against the CPU's: particles by identity atol
    1e-4; grids by the reference's cross-path tolerance (1-px smoothed
    rtol 5e-2 / atol 2e-2, totals rtol 1e-3; float atomics reorder the
    sums)."""
    def smooth(img):
        k = torch.ones(1, 1, 3, 3) / 9.0
        return torch.nn.functional.conv2d(img[:, None], k, padding=1)[:, 0]

    err = (by_id(cpu.sim) - by_id(gpu.sim)).abs().max().item()
    if err > 1e-4:
        fail(f"{label} card vs CPU: particles differ by {err:.3e}")
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


def spawned_pair(view_res):
    """A root-64 engine on the CPU and one on the card, from one spawn."""
    import tendrils_tpu_torch as tt
    from tendrils_tpu_torch import convert
    from tendrils_tpu_torch.models.configs import _backends
    from tendrils_tpu_torch.ops import spawn
    cfg = tt.EngineConfig(root_num=64, view_res=view_res, **_backends())
    cpu, gpu = (tt.Tendrils(cfg, device=dev).setup()
                for dev in ("cpu", "cuda"))
    cpu.spawn_shader(lambda p, e: spawn.ball(p, e._frag_xy, 0.6, 0.01))
    gpu.timer.tick()
    gpu.sim = convert.sim_from_numpy(convert.sim_to_numpy(cpu.sim), "cuda")
    return cpu, gpu


def agree_with_plain():
    """Config 2's frame: a small run on the card against the same run on
    the CPU (plain versions), 3 frames."""
    cpu, gpu = spawned_pair((1080, 1920))
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


def main():
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

    from tendrils_tpu_torch.ops import cuda_lib
    if "jax" in sys.modules:
        fail("the port imported jax")

    t0 = time.perf_counter()
    cuda_lib.library()
    built = cuda_lib.build_seconds
    print(f"[2] kernels built in {time.perf_counter() - t0:.1f} s "
          f"(nvcc {'cached' if built is None else f'{built:.1f} s'})")

    print("[3] kernels vs plain versions at config-2 shapes:")
    checks = check_config2_kernels()
    print("[3] kernels vs plain versions at config-4 shapes:")
    checks.update(check_config4_kernels())

    eng, launches2 = run_config2()
    err_p, grids = replay(eng)
    print(f"[5] K2 replay of one config-2 frame: particles max |d| "
          f"{err_p:.3e} (atol 1e-4), flow max |d| {grids['flow']:.3e}, view "
          f"max |d| {grids['view']:.3e} (each channel <= 1e-5 x its max), "
          f"force max |d| {grids['force']:.3e} (<= 1e-5 x its flow "
          f"channel's max)")
    launches4 = run_config4()
    if "jax" in sys.modules:
        fail("the port imported jax")

    print(card)
    print(json.dumps({"kernels": [
        {"name": k, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches2.get(k, 0) + launches4.get(k, 0),
         **{key: checks[k][key] for key in (
             "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
             "library_ms")}}
        for k, (src, rep) in KERNELS.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
