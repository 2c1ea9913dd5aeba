"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints a line; any failure exits non-zero before the result):
  1. the card (nvidia-smi name and power limit), torch and CUDA versions;
  2. build the kernels (nvcc, from tendrils_tpu_torch/csrc/);
  3. each kernel against its plain PyTorch version on the card, at the
     main path's shapes (config 2: 1,048,576 particles, 1080x1920), with its
     median time beside the plain version's (CUDA events);
  4. the main path through the user's entry points: `models.build("1m-flow")`,
     two facade frames, `run_headless` for 60 steps. Every kernel must have
     launched and no plain version may have run; the state must be alive
     and finite. Then ms/frame and particle-steps/s as the median of 3 timed
     60-step runs, and a small run on the card against the same run on the
     CPU (plain versions).
The last two lines are the per-kernel JSON and the result JSON.
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
# Kernel -> (route source, the TPU kernel it replaces).
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
}


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


def check_kernels():
    """Phase 3: returns {name: (max_abs_err, ms, plain_ms)}."""
    from tendrils_tpu_torch.ops import draw_cuda, gather_cuda
    from tendrils_tpu_torch.ops.tile_geom import pad_dims
    dev = torch.device("cuda")
    n, (h, w) = 1 << 20, (1080, 1920)
    sl, time_, fdecay = 0.01, 1000.0, 0.005
    rng = np.random.default_rng(0)
    pos, vel, live, idx, vs = resident_inputs(rng, n, (h, w), sl)
    t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    pos_t, vs_t = t(pos), t(vs)
    p1 = torch.stack([(pos_t[0] * vs_t[0] * 0.5 + 0.5) * w,
                      (pos_t[1] * vs_t[1] * 0.5 + 0.5) * h], dim=-1)
    hp, wp = pad_dims(h, w)
    pscale = draw_cuda._pos_scale(hp, wp)
    scal = draw_cuda._draw_scal(
        sl, time_, 5.0, 1.0, 1e-6, float(np.sin(time_ * fdecay)), fdecay,
        t(np.float32([1, 1, 1, 0.5])), t(np.float32([1, 1, 1, 0.04])),
        t(np.float32([0.2, 0.5, 0.8, 1.0]) * np.float32(0.4)), vs_t, dev)
    out = {}

    # K1: integer words, bit-exact.
    pack_args = (scal, p1, t(vel), t(live), t(idx))
    kw = dict(grid_hw=(h, w), pscale=pscale)
    got = draw_cuda.pack(*pack_args, **kw)
    want = draw_cuda.pack_plain(*pack_args, **kw)
    for name, a, b in zip(("keym", "p1", "vl"), got, want):
        if not torch.equal(a, b):
            fail(f"pack {name}: {(a != b).sum().item()} words differ")
    err = max((a.long() - b.long()).abs().max().item()
              for a, b in zip(got, want))
    out["pack"] = (err, median_ms(lambda: draw_cuda.pack(*pack_args, **kw),
                                  50),
                   median_ms(lambda: draw_cuda.pack_plain(*pack_args, **kw),
                             10))
    print(f"  K1 pack: bit-exact keym/p1/vl; {out['pack'][1]:.4f} ms "
          f"(plain {out['pack'][2]:.4f} ms)")

    # K2 on the sorted stream: float atomics add in run-dependent order,
    # so |d| <= 1e-5 x the channel's max.
    keym_s, perm = torch.sort(got[0])
    p1_s, vl_s = got[1][perm], got[2][perm]
    kw = dict(samples=2, grid_hw=(h, w), pscale=pscale)
    acc = draw_cuda.splat(scal, p1_s, vl_s, **kw)
    ref = draw_cuda.splat_plain(scal, p1_s, vl_s, **kw)
    scale = ref.abs().reshape(ref.shape[0], -1).amax(dim=1)
    err = (acc - ref).abs().reshape(ref.shape[0], -1).amax(dim=1)
    if not (err <= 1e-5 * scale).all():
        fail(f"splat: per-channel max |d| {err.tolist()} vs max "
             f"{scale.tolist()}")
    out["splat"] = (err.max().item(),
                    median_ms(lambda: draw_cuda.splat(scal, p1_s, vl_s, **kw),
                              20),
                    median_ms(lambda: draw_cuda.splat_plain(
                        scal, p1_s, vl_s, **kw), 3))
    print(f"  K2 splat: max |d| {out['splat'][0]:.3e} (<= 1e-5 x channel "
          f"max); {out['splat'][1]:.4f} ms (plain {out['splat'][2]:.4f} ms)")

    # K3, K4, K5: rtol 1e-5 (atol 1e-6 for values near 0).
    def close(name, got, want):
        err = max((a - b).abs().max().item() for a, b in zip(got, want))
        for a, b in zip(got, want):
            if not torch.allclose(a, b, rtol=1e-5, atol=1e-6):
                fail(f"{name}: max |d| {err:.3e}")
        return err

    flow = torch.rand((4, h, w), device=dev) * 0.02 - 0.01
    flow[2] = torch.rand((h, w), device=dev) * time_
    flow[3] = torch.rand((h, w), device=dev)
    view = torch.rand((4, h, w), device=dev)
    rscal = draw_cuda._resolve_scal(
        t(np.float32([0.1333, 0.1333, 0.1333, 0.05])), 0.0, time_,
        time_ + DT, fdecay, 5.0, 1.0, dev)
    args = (rscal, acc, flow, view)
    res = draw_cuda.resolve(*args, want_eff=True)
    out["resolve"] = (
        close("resolve", res, draw_cuda.resolve_plain(*args, want_eff=True)),
        median_ms(lambda: draw_cuda.resolve(*args, want_eff=True), 50),
        median_ms(lambda: draw_cuda.resolve_plain(*args, want_eff=True), 10))

    eff = res[2]
    args = (eff, p1_s, pos_t[0][perm], pos_t[1][perm], vl_s,
            torch.full((1,), sl, device=dev))
    kw = dict(inv_p=1.0 / pscale)
    out["gather_reconstruct"] = (
        close("gather_reconstruct", gather_cuda.gather_reconstruct_p1(
            *args, **kw), gather_cuda.gather_reconstruct_plain(*args, **kw)),
        median_ms(lambda: gather_cuda.gather_reconstruct_p1(*args, **kw), 50),
        median_ms(lambda: gather_cuda.gather_reconstruct_plain(*args, **kw),
                  10))

    # K5 at the particles' positions, plus points on and past the edges.
    x = ((pos_t[0] * vs_t[0]) * 0.5 + 0.5) * w
    y = ((pos_t[1] * vs_t[1]) * 0.5 + 0.5) * h
    x[:4] = torch.tensor([w - 0.5, w, w + 3.0, -2.0], device=dev)
    y[:4] = torch.tensor([h - 0.5, h, 0.25, h + 5.0], device=dev)
    out["bilinear_gather"] = (
        close("bilinear_gather", [gather_cuda.bilinear_gather(eff, x, y)],
              [gather_cuda.bilinear_gather_plain(eff, x, y)]),
        median_ms(lambda: gather_cuda.bilinear_gather(eff, x, y), 50),
        median_ms(lambda: gather_cuda.bilinear_gather_plain(eff, x, y), 10))
    for k in ("resolve", "gather_reconstruct", "bilinear_gather"):
        e, ms, pms = out[k]
        print(f"  {k}: max |d| {e:.3e} (rtol 1e-5); {ms:.4f} ms "
              f"(plain {pms:.4f} ms)")
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


def agree_with_plain():
    """A small run on the card against the same run on the CPU (plain
    versions), from one spawn: particles by identity atol 1e-4; grids by
    the reference's cross-path tolerance (1-px smoothed rtol 5e-2 / atol
    2e-2, deposit totals rtol 1e-3; float atomics reorder the sums)."""
    import tendrils_tpu_torch as tt
    from tendrils_tpu_torch import convert
    from tendrils_tpu_torch.models.configs import _backends
    from tendrils_tpu_torch.ops import spawn
    cfg = tt.EngineConfig(root_num=64, view_res=(1080, 1920), **_backends())
    cpu, gpu = (tt.Tendrils(cfg, device=dev).setup()
                for dev in ("cpu", "cuda"))
    cpu.spawn_shader(lambda p, e: spawn.ball(p, e._frag_xy, 0.6, 0.01))
    gpu.timer.tick()
    gpu.sim = convert.sim_from_numpy(convert.sim_to_numpy(cpu.sim), "cuda")
    for _ in range(3):
        cpu.frame()
        gpu.frame()

    def by_id(sim):
        return sim.particles.cpu()[:, torch.argsort(sim.idx.cpu())]

    def smooth(img):
        k = torch.ones(1, 1, 3, 3) / 9.0
        return torch.nn.functional.conv2d(img[:, None], k, padding=1)[:, 0]

    err = (by_id(cpu.sim) - by_id(gpu.sim)).abs().max().item()
    if err > 1e-4:
        fail(f"card vs CPU: particles differ by {err:.3e}")
    for name in ("flow", "view"):
        a = getattr(cpu.sim, name).reshape(-1, 1080, 1920)
        b = getattr(gpu.sim, name).cpu().reshape(-1, 1080, 1920)
        if not torch.allclose(smooth(b), smooth(a), rtol=5e-2, atol=2e-2):
            fail(f"card vs CPU: {name} differs")
        if not torch.allclose(b.sum(), a.sum(), rtol=1e-3):
            fail(f"card vs CPU: {name} totals {b.sum()} vs {a.sum()}")
    return err


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

    import tendrils_tpu_torch as tt
    from tendrils_tpu_torch import models
    from tendrils_tpu_torch.ops import cuda_lib
    if "jax" in sys.modules:
        fail("the port imported jax")

    t0 = time.perf_counter()
    cuda_lib.library()
    built = cuda_lib.build_seconds
    print(f"[2] kernels built in {time.perf_counter() - t0:.1f} s "
          f"(nvcc {'cached' if built is None else f'{built:.1f} s'})")

    print("[3] kernels vs plain versions at config-2 shapes:")
    checks = check_kernels()

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
    missing = [k for k in KERNELS if launches.get(k, 0) == 0]
    if missing or any(plain.values()):
        fail(f"main path launches {launches}, plain calls {plain}")
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
    sec = statistics.median(times) / STEPS
    err = agree_with_plain()
    runs = ", ".join(f"{t / STEPS * 1e3:.3f}" for t in times)
    print(f"[4] 1m-flow: 2 frames + {STEPS} headless steps, launches "
          f"{launches}, no plain calls; {alive} alive, {texels} flow texels; "
          f"{sec * 1e3:.3f} ms/frame, {eng.config.n / sec:.0f} "
          f"particle-steps/s (median of 3 x {STEPS} steps: {runs} ms/frame); "
          f"card vs CPU particles max |d| {err:.2e}")

    print(card)
    print(json.dumps({"kernels": [
        {"name": k, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[k], "max_abs_err": checks[k][0],
         "ms": checks[k][1], "plain_ms": checks[k][2]}
        for k, (src, rep) in KERNELS.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
