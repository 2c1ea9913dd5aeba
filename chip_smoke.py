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
     3 calls for a plain version; a trace that lost a device event is
     taken again); beside a kernel's, its cold device times (the same,
     with a buffer of twice the card's L2 written, or read, before each
     call so that no input is left in L2; the flush's kernels are left
     out by name, and each flush's time alone is printed first) and its
     call time (CUDA events around 20 back-to-back calls, over 20: the
     host's enqueue included). K1-K5 at the config-2 shapes
     (1,048,576 particles, 1080x1920), K6, K8 and K9 at the config-4
     shapes (262,144 particles, 720x1280; K9 at a pointer frame's samples
     and at 2 x 262,144, then through spread, pointer, empty, off-grid,
     pointer calls on its kept scratch, each equal to a fresh call, and
     a pointer call on a second stream, which keeps a scratch of its own);
  4. config 2 through the user's entry points: `models.build("1m-flow")`,
     two facade frames, `run_headless` for 60 steps. Every kernel of the
     path must have launched and no plain version may have run; the state
     must be alive and finite. Then ms/frame and particle-steps/s as the
     median of 3 timed 60-step runs, and a small run on the card against
     the same run on the CPU (plain versions);
  5. the replay contract: the same frame twice from one converted state
     gives the same state bit for bit (`torch.equal` of every tensor:
     particles, previous, flow, view, the carried force, the row order),
     as the JAX package's does (K2 and K9 sum in int64 fixed point): the
     config-2 frame; at config 3 the resident frame right after a ball
     respawn (its strays and split tiles printed); at config 4 an io frame
     with pointer samples (K9);
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
     off: 2 warm steps and 3 timed runs of 10;
 12. config 1 as `bench.py:180-186` builds it (`models.build(
     "default-preview", view_res=(720, 1280))`, a ball spawn, then
     `flowWeight = 0`): two facade frames and `run_headless` for 60 steps
     (resident: K1, K2 and K3 view-only, K6), then one classic frame (the
     p0 + rgba8 view-only K2); the counters must show no K4, K5 or K7 and
     no plain version, the flow grid must stay bit-equal to its value
     before the frames; JAX's contract (tests/test_carry_force.py:177-227)
     on the card, classic and resident: from one converted state, 4 frames
     gated and 4 with the gate forced off give particles equal by identity
     and views equal bit for bit; then ms/frame and particle-steps/s as the
     median of 3 timed 60-step runs, and a small run against the CPU;
 13. config 5's show frame uncut on phase 10's engine: `step_draw_io(
     bokeh=(3.0, 40.0))` with the `noiseScale` modulation of
     `bench.py:358-365`, 2 warm frames and 3 timed runs of 10, the screen
     [4, 2160, 3840] and finite, beside phase 10's headless ms/frame;
     then bokeh alone on the show frame's view (the blur stack's windowed
     boxes), its max |d| and p99.9 against the same bokeh in float64 on
     the card and its device ms; it must be within 5e-3 max and 2e-3
     p99.9;
 14. the spawners and live targets, on the demo's wiring
     (`tendrils_tpu/app/demo.py:99-115, 271-332`): at config 5 on phase
     10's engine (gather mode 3) a `direct` target spawn from the
     synthetic 480x640 camera frame (its device ms at 16.8M rows), 2 warm
     steps and 3 timed runs of 10 of `run_headless(targets_live=True)`,
     beside phase 10's figure; at config 2 a ball spawn, then each
     spawner once (`flow-sample` from the flow, `data-sample` from the
     particles, `GeometrySpawner.shuffle()`, `direct` and `best-sample`
     from the camera), each timed and each followed by a frame that
     gathers its force with K5, then a `direct` target spawn with
     `target` 0.003, 2 facade frames and `run_headless(targets_live=
     True)` for 60 steps (K4 with targets once a frame, no plain call;
     the targets by identity the spawned xy bit for bit, their velocity
     rows zero), then the median of 3 timed 60-step runs beside phase
     4's, and a small run against the CPU; at config 4 the demo's
     `spawn_image_targets` (a target spawn, then a plain spawn, from the
     camera), 2 warm io frames and 3 timed runs of 20 (K6 with targets
     once a frame) beside phase 6's; then the facade's helpers: config 2
     resized to 720x1280 and back, a frame after each, and `step_buffers`
     on two view buffers;
 15. the demo application (`app.TendrilsDemo`) at the CLI's defaults
     (720x1280, quality 0: 262,144 particles, `DEMO_CLI`): (a) with a WAV
     track playing (`animate=true`: the track timeline and triggers run),
     the synthetic 480x640 camera and 4 pointers every frame, each of the
     41 presets applied and 3 frames rendered, each leaving a finite
     state, live particles (but where the track timeline's `reset` has
     just emptied the sim) and a finite [4, 720, 1280] screen; (b)
     `render()` timed for `Flow` and `Pissarides`, median of 3 x 20, at
     quality 0 and quality 2 (4,194,304 particles, gather mode 3), beside
     phase 6's io frame; the launch counts of (a) and (b), every kernel
     of `DEMO_PATH` launched, no plain call; (c) the CLI in a subprocess
     (`python -m tendrils_tpu_torch --preset Flow --frames 30 --every
     10`: 3 PNGs of 720x1280, `final.ckpt.npz`, its JSON line), then
     resumed from that checkpoint for one frame; (d) 5 frames of `Flow`,
     a checkpoint, 3 frames, against a fresh demo that loads the
     checkpoint and renders the same 3: equal bit for bit, or particles
     by identity within atol 1e-4, the first forces' difference (K5
     re-gathered against K4's carried) printed.
 16. the generic draw (`fused_draw=False`, the "xla" backends, a flow grid
     of its own, a flow pyramid): (a) config 2 (`GENERIC`, a ball spawn
     as `models.build("1m-flow")`) on the generic kernel draw, two facade
     frames and 3 timed runs of 60 headless steps (K5 once a step, K9
     twice a frame, nothing else, no plain call), a frame replayed bit
     for bit, a small run against the CPU, and K9 on the frame's two
     passes (2,097,152 samples each) equal to its plain version, timed;
     (b) the same on "xla"/"xla" (no launch), and one draw from (a)'s
     state on the f32 scatter within rtol/atol 1e-4 of K9's; (c) the
     fused draw against the generic ones at unit line widths, held to
     tests/test_fused_draw.py:33-66's tolerances at its size, counted at
     config 2 (where saturated alphas defeat them; `fused_against_generic`);
     (d) the JAX package's
     default `EngineConfig()` (262,144 particles, 720x1280, flow 4 x 3,
     view 4 x 1) on both backends; (e) config 2 with `flow_levels=2` (K5
     on both levels, held to its plain version) and with `flow_res=(540,
     960)`; (f) the config-4 io frame on both backends and `python -m
     tendrils_tpu_torch --backend xla`; (g) `geom` on its native path,
     `utils.profiling.FrameProfiler` and `trace` around generic frames.
     Each time beside the card's name and power limit.
 17. the sharded frames (`tendrils_tpu_torch.parallel`) on the card: K2
     with `adds_rows` (at 2n equal to its plain version bit for bit on a
     seeded config-2 stream; its split conversion equal to the four-launch
     call; two halves' int64 sums adding up to the whole's); (a) NCCL at
     world size 1 in this process (a `file://` store): `ParallelTendrils`
     at config 2 for 10 frames, every tensor equal bit for bit to the
     single-device `Tendrils` from one state, and `SpatialTendrils` for 3
     frames within tests/test_parallel.py's slab tolerances of the single
     device's classic frame with the XLA tail, each timed beside the
     single device, with the collective bytes a frame; (b) 2 gloo ranks
     in processes of their own sharing the card (NCCL refuses two ranks on
     one GPU): data-parallel at config 3 (gather mode 3 on both sides),
     every row by identity and both grids equal bit for bit to a
     single-device run on each rank; at config 2 (a shard in mode 3, one
     device in mode 1) within the mode-3 rule (particles by identity
     within 1e-4, grid totals within 1e-4; the texels beyond
     tests/test_parallel.py:76-81 and the force's max |d| printed), and
     equal bit for bit to one device forced into mode 3; slab at
     config 2; the merge reorder at config 3 for 3 frames, merged and
     fallback counts per rank; (c) 4 gloo ranks: the (2, 2) multi-host
     mesh at config 2 equal bit for bit to the flat mesh. The ranks'
     launch counts join the per-kernel JSON's.
Phase 3 also holds K4 with targets at config 2 and K6 with targets at
config 4 against their plain versions (`torch.equal` on the targets, a
copy; K4's force within rtol 1e-5) and against K4 and K6 without them,
and K4 with targets == K8 + K6 with targets bit for bit.
Phase 3 also holds K13, the logic step, equal bit for bit to its plain
version at 1,048,576 and 16,777,216 particles and at a root of 1,000 (so
that 1 / root is inexact), after the ball spawn and after 3 frames, with
each force source (the carried force, K5's gather, none under flow_off),
printing the words that differ and the largest gap in ulps where any
does; at 16,777,216 it is timed warm, cold and in a frame beside its bound
at 52 B a particle, and the issue time of its SASS (cuobjdump's count
of its instructions, its registers and stack) is printed beside that.
Phase 6 also runs the demo's vignette blur (`feeds.DEMO_BLUR`) on 3
config-4 io frames, their screens checked and timed. Phase 3 also holds
K2's view-only launch (flow_off) in every variant on config 1's and
config 2's seeded streams, bit-equal to planes 5-10 of the 11-channel
call on the same stream, the same bits on two calls, equal to its plain
version (both sum in int64 at the same fixed-point steps), and K3
view-only against its plain
version and bit-equal to K3's view from the 11 channels, timed at config
1.
Phase 3 holds K2 (four launches: the plan, the tile pass in shared
memory, the strays, the conversion of its int64 sums) in every variant
on four more sorted streams: a real config-2 frame's after 30 frames, a
classic p0 stream with long segments (its stray pass must add samples),
a real config-3 frame's (keys in the merge's order; it must split
tiles) and a late config-5 frame's (950 frames: the particles clustered
into filaments), printing the partition the kernels ran on each (rows a
tile, split tiles, the stray pass's count); on every stream each variant
runs twice and must give the same bits, as K9 must at config 4, and the
stream's own variant's int64 sums must equal the plain version's. It holds K5 (two launches
for the 2-channel flow: the interleaved copy, the gather) at config 2,
with 3 channels, and at config-3 and config-5 shapes (4,194,304 and
16,777,216 points after a ball spawn, edge points included) within rtol
1e-5 of its plain version, and times it against `F.grid_sample` in
alternating turns at each; K7 within 1 per q15 field on the seeded
classic config-2 stream, a real classic config-2 frame's after 30 frames,
path B's paused config-4 frame's (262,144 rows) and config 3's
gather-mode-2 frame (phase 10), printing the words that differ and its
device time on each; K12 against `F.grid_sample` in turns; the K1/K2 variants with
the p0 and rgba8 streams, K12 (with `F.grid_sample` as its library
yardstick), K10 and K11 on
the merge inputs recorded from real config-3 and config-2 frames, K11
also on 4M-row synthetic merges at config 3's tiles (churn at n/8, at
n/8 + 1 with `ok` false, and a tenth of the rows into one tile), with
the boolean-mask selection as K10's yardstick and the flat `torch.sort`
printed beside the whole merge, and K1 in gather modes 3 and 2 against
their plain versions, and K1 in gather mode 3 with rgba8 colours
(`pack_rgba_g3`, the demo's quality 2) at 4,194,304 rows and 720x1280,
with K2's rgba8 variant on its stream. The last three lines are the
card, the per-kernel JSON and the result JSON.
"""

import collections
import dataclasses
import functools
import itertools
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

# The card's memory rate, the spin kernels that open a trace
# (`time_calls`) and the host's CUDA runtime calls that ask for a device
# event (a kernel, a copy, a fill), by the names `torch.profiler` records
# them under: the benchmark's, so that one change moves both.
from benchmark.trace import HBM_BYTES_PER_S, PAD_LAUNCHES, RUNTIME_CALLS

STEPS = 60
DT = 1000.0 / 60.0
IO_FRAMES = 20
F32_OPS_PER_S = 67e12  # H100 SXM f32 outside the tensor cores
REPS = 20  # back-to-back calls a kernel or a library call is timed over
PLAIN_REPS = 1  # the same for a plain version: a plain splat's trace holds
# many small launches, which the profiler is slow to read
LIB_ROUNDS = 7  # alternating turns of a kernel against its library call
PROFILE_TRIES = 3  # traces a timing takes before it gives up
TRACES = collections.Counter()  # traces `time_calls` took, and retook
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
    # The demo's resident frame at quality 2 (4,194,304 rows, rgba8
    # colours): K1 with key_recon and rgba8 in gather mode 3.
    "pack_rgba_g3": ("tendrils_tpu_torch/csrc/pack.cu",
                     "tendrils_tpu/ops/draw_pallas.py:758"),
    # flow_off (config 1): K2's view-only launch, resident and classic, and
    # K3's view-only variant.
    "splat_view": ("tendrils_tpu_torch/csrc/splat.cu",
                   "tendrils_tpu/ops/draw_pallas.py:179"),
    "splat_p0_rgba_view": ("tendrils_tpu_torch/csrc/splat.cu",
                           "tendrils_tpu/ops/draw_pallas.py:179"),
    "resolve_view": ("tendrils_tpu_torch/csrc/resolve.cu",
                     "tendrils_tpu/ops/draw_pallas.py:1284"),
    # Live targets riding the resident sort: K4 and K6 re-stacking them.
    "gather_reconstruct_targets": ("tendrils_tpu_torch/csrc/gather.cu",
                                   "tendrils_tpu/ops/gather_pallas.py:481"),
    "reconstruct_resident_targets": ("tendrils_tpu_torch/csrc/gather.cu",
                                     "tendrils_tpu/ops/draw_pallas.py:1529"),
    # The generic draw (phase 16): K9 on both passes of every frame,
    # 2,097,152 samples a pass at config 2.
    "splat_points_generic": ("tendrils_tpu_torch/csrc/splat_points.cu",
                             "tendrils_tpu/ops/splat_pallas.py:125"),
    # The logic step, which no TPU kernel holds (XLA fuses it).
    "logic_step": ("tendrils_tpu_torch/csrc/logic.cu",
                   "tendrils_tpu/ops/logic.py:46"),
}
CONFIG2_PATH = ("pack", "splat", "resolve", "gather_reconstruct",
                "bilinear_gather")
CONFIG4_PATH = ("pack", "splat", "resolve", "bilinear_gather",
                "reconstruct_resident", "gather_keyed_p1", "splat_points")
# Launches a frame of each new path (the others: none); K2 launches
# four kernels a call (the plan, the tile pass, the strays, the
# conversion), K5 two on the 2-channel flow (the interleaved copy, the
# gather), K9 three (the channel bounds, the adds and marks, the
# conversion); a frame that steps launches K13 once, a paused one never.
K2 = 4
K5 = 2
K9 = 3
PATH_A = {"pack_p0_rgba": 1, "splat_p0_rgba": K2, "resolve": 1,
          "gather_keyed_q15": 1, "logic_step": 1}
PATH_C_RUNNING = {"pack_rgba": 1, "splat_rgba": K2, "resolve": 1,
                  "reconstruct_resident": 1, "gather_keyed_p1": 1,
                  "splat_points": K9, "logic_step": 1}
PATH_C_PAUSED = {"pack_p0_rgba": 1, "splat_p0_rgba": K2, "splat_points": K9}
PATH_B = {"pack_p0_rgba": 1, "splat_p0_rgba": K2, "gather_keyed_q15": 1}
# The resident frame with the merge on (K1 "pack" is "pack_g3" in gather
# mode 3), with it off at configs 3 and 5, and the gather-mode-2 frames.
MERGE_C2 = {"pack": 1, "splat": K2, "resolve": 1, "gather_reconstruct": 1,
            "reorder_compact": 1, "reorder_apply": 1, "logic_step": 1}
CONFIG3_OFF = {"pack": 1, "splat": K2, "resolve": 1, "gather_reconstruct": 1,
               "logic_step": 1}
CLASSIC_G2 = {"pack_p0_rgba_g2": 1, "splat_p0_rgba": K2, "resolve": 1,
              "gather_keyed_q15": 1, "logic_step": 1}
PAUSED_G2 = {"pack_p0_rgba_g2": 1, "splat_p0_rgba": K2,
             "gather_keyed_q15": 1}
# Config 1 (flowWeight 0): the resident frame on K2 and K3 view-only and K6,
# the classic frame on the p0 + rgba8 view-only K2; no gather.
CONFIG1_RESIDENT = {"pack": 1, "splat_view": K2, "resolve_view": 1,
                    "reconstruct_resident": 1, "logic_step": 1}
CONFIG1_CLASSIC = {"pack_p0_rgba": 1, "splat_p0_rgba_view": K2,
                   "resolve_view": 1, "logic_step": 1}
SHOW_BOKEH = (3.0, 40.0)  # config 5's show frame (`bench.py:352-378`)
# Bokeh in f32 against float64 at 2160x3840, the most |d| the blur stack
# may read: it reads ~3e-7 on an H100; TF32 or bf16 (~1e-3 relative on
# values near 1) would read two orders over.
BOKEH_F32_MAX = 1e-5
SEG = 10  # headless steps of a config-3 segment and a config-5 timed run
# Phase 15, the demo at the CLI's defaults (`tendrils_tpu/__main__.py:24,
# 56-58`): 720x1280, quality 0 (root 512, 262,144 particles), the engine
# arguments below.
DEMO_RES = (720, 1280)
DEMO_ROOT = 512
DEMO_CLI = dict(flow_samples=2, flow_rows=1, view_samples=2)
DEMO_FRAMES = 3  # frames of each preset in phase 15 (a)
DEMO_POINTERS = 4
DEMO_TIMED = ("Flow", "Pissarides")  # presets timed in phase 15 (b)
# The demo frame's kernels with a camera and pointers every frame: the
# resident draw with rgba8 colours (the audio and camera colour maps), K3
# (or the XLA tail at line widths over KMAX_WIDTH), K6 with the targets
# (live after every restart) and K8 after the flow edits, K9 for the
# pointers, K5 after each spawn; at quality 2, K1 in gather mode 3.
DEMO_PATH = ("pack_rgba", "splat_rgba", "resolve",
             "reconstruct_resident_targets", "gather_keyed_p1",
             "splat_points", "bilinear_gather", "pack_rgba_g3")


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


@functools.cache
def l2_flush(kind):
    """What a cold timing runs before each call so that the call finds
    none of its inputs in L2, on an int16 buffer of twice the card's L2
    (`L2_cache_size`; no kernel's wrapper runs an int16 fill or max):
    "write" fills it, which leaves every line of L2 dirty, so that the
    timed call also pays to write them back as it reads; "read" takes the
    max of each 1,024-element row, which leaves L2 clean (its 100 KB of
    results aside). `(flush, ms, names)`: the function, its device ms
    alone, and its kernels' names, which a cold timing leaves out."""
    l2 = torch.cuda.get_device_properties(0).L2_cache_size
    buf = torch.ones((l2 // 1024, 1024), dtype=torch.int16, device="cuda")
    flush = {"write": lambda: buf.fill_(1),
             "read": lambda: buf.amax(1)}[kind]
    ms, _, kernels = time_calls(flush)
    return flush, ms, set(kernels)


def time_calls(fn, reps=REPS, cold=None, strict=True):
    """`(device ms, call ms, {kernel: device ms})` of one call of `fn`, each
    over `reps` back-to-back calls after a warm one: the device time of
    the kernels, copies and fills they ran, by `torch.profiler`, summed
    and divided by `reps`; and the time between CUDA events around them,
    divided by `reps`: what a caller pays, the host's enqueue included.
    With `cold` ("write" or "read"), `l2_flush(cold)` runs before each
    traced call and its kernels are left out by name (none may run more
    than once a call, so `fn` shares none of them); the call ms is None.

    A trace counts only if it holds a device event for each launch, copy
    and fill that the host's CUDA runtime calls in it asked for, and if
    each kernel, copy and fill ran a whole number of times a call (`fn`
    launches the same work on each call): a trace can lose events of its
    own and hold as many left over from the trace before it, which keeps
    the total and halves the time. After a trace of many launches (a
    plain splat's), the profiler loses the first device events of later
    traces, and now and then it hands back a trace with none, so each
    trace opens with PAD_LAUNCHES spin kernels, left out by name, twice as
    many at each try; a trace that still fails a check is traced again,
    and after PROFILE_TRIES the run fails, or, with `strict=False` (plain
    torch code whose time is reported, not held to a bound), the device
    ms is None: not measured."""
    from torch.profiler import ProfilerActivity, profile
    flush, _, flush_names = l2_flush(cold) if cold else (None, 0.0, ())
    fn()
    torch.cuda.synchronize()
    call_ms = None
    if not cold:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        call_ms = start.elapsed_time(end) / reps
    for attempt in range(PROFILE_TRIES):
        pads = PAD_LAUNCHES << attempt
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(pads):
                torch.cuda._sleep(1)
            torch.cuda.synchronize()
            for _ in range(reps):
                if flush is not None:
                    flush()
                fn()
            torch.cuda.synchronize()
        asked = recorded = 0
        names = {}
        uneven = {}
        for ev in prof.key_averages():
            if ev.device_type != torch.autograd.DeviceType.CUDA:
                if ev.key.startswith(RUNTIME_CALLS):
                    asked += ev.count
                continue
            if "spin_kernel" in ev.key:
                continue
            recorded += ev.count
            if ev.key in flush_names:
                if ev.count > reps:
                    fail(f"cold timing: {ev.key} ran {ev.count} times in "
                         f"{reps} calls, the L2 flush runs it once a call")
                continue
            if ev.count % reps:
                uneven[ev.key.split("(")[0][-60:]] = ev.count
            if ev.self_device_time_total > 0:
                names[ev.key] = ev.self_device_time_total / 1e3 / reps
        TRACES["traces"] += 1
        if names and recorded == asked - pads and not uneven:
            return sum(names.values()), call_ms, names
        TRACES["traced again"] += 1
        print(f"  (a trace after {pads} spin kernels holds {recorded} of "
              f"the {asked - pads} device events its calls asked for"
              + (f", and events that ran no whole number of times in its "
                 f"{reps} calls: {uneven}" if uneven else "")
              + "; tracing again)")
        time.sleep(1.0)
    if not strict:
        return None, call_ms, {}
    fail(f"torch.profiler lost device events in each of {PROFILE_TRIES} "
         f"traces")


def timed_row(out, name, err, fn, plain_fn, nbytes, ops, library_fn=None,
           plain_reps=PLAIN_REPS, label=""):
    """Time a kernel's wrapper (`fn`), warm and cold after each flush, its
    plain version and, where one PyTorch call computes the same function,
    that call; store the row `out[name]` with the bound and print it."""
    ms, call_ms, _ = time_calls(fn)
    cold_ms = time_calls(fn, cold="write")[0]
    cold_clean_ms = time_calls(fn, cold="read")[0]
    plain_ms = time_calls(plain_fn, plain_reps)[0]
    library_ms = None if library_fn is None else time_calls(library_fn)[0]
    b, by = bound(nbytes, ops)
    out[name] = dict(max_abs_err=err, ms=ms, cold_ms=cold_ms,
                     cold_clean_ms=cold_clean_ms, call_ms=call_ms,
                     plain_ms=plain_ms, bound_ms=b, bound_by=by,
                     library_ms=library_ms)
    print(f"  {name}{label}: max |d| {err:.3e}; device {ms:.4f} ms, cold "
          f"{cold_ms:.4f} ms (clean L2 {cold_clean_ms:.4f} ms), call "
          f"{call_ms:.4f} ms (plain {plain_ms:.4f} ms, bound {b:.4f} ms by "
          f"{by}" + ("" if library_ms is None
                     else f", library {library_ms:.4f} ms") + ")")


def against_library(name, fn, library_fn, rounds=LIB_ROUNDS):
    """A kernel and the library call that computes the same function,
    each timed by device ms (`time_calls`) in `rounds` alternating turns:
    prints both medians, their ranges and the median of the turns'
    differences, which a gap must clear to stand; and both medians of the
    call ms of the same turns."""
    ks, ls, kc, lc = [], [], [], []
    for _ in range(rounds):
        for dev, call, f in ((ks, kc, fn), (ls, lc, library_fn)):
            ms, call_ms, _ = time_calls(f)
            dev.append(ms)
            call.append(call_ms)
    diff = statistics.median(k - lib for k, lib in zip(ks, ls))
    print(f"  {name} against the library call, {rounds} alternating turns "
          f"of {REPS} calls: device {statistics.median(ks):.4f} ms "
          f"({min(ks):.4f}-{max(ks):.4f}), library "
          f"{statistics.median(ls):.4f} ms ({min(ls):.4f}-{max(ls):.4f}); "
          f"kernel - library, median of the turns {diff * 1e3:+.2f} us; "
          f"call ms {statistics.median(kc):.4f} ({min(kc):.4f}-"
          f"{max(kc):.4f}), library {statistics.median(lc):.4f} "
          f"({min(lc):.4f}-{max(lc):.4f})")


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


def equal(name, got, want):
    """K4's and K6's targets (a copy) and K6's state: `torch.equal`."""
    if not torch.equal(got, want):
        fail(f"{name}: {(got != want).sum().item()} values differ")


def target_streams(n, seed):
    """Sorted targets riding a resident draw: xy in the view, a tenth of
    the rows inert."""
    rng = np.random.default_rng(100 + seed)
    t = rng.uniform(-1.0, 1.0, (2, n)).astype(np.float32)
    t[:, rng.random(n) < 0.1] = -1.0e6
    return tuple(torch.as_tensor(v, device="cuda") for v in t)


def equal_to_plain(name, got, want):
    """K2, K9 against their plain versions: both quantise each add at the
    channel's fixed-point step and sum in int64, so they must give the
    same bits; on a difference, fails with the values that differ and the
    largest |d| of each channel. `got`, `want`: [C, ...]. Returns the max
    |d|, 0."""
    if torch.equal(got, want):
        return 0.0
    c = want.shape[0]
    d = (got.double() - want.double()).abs().reshape(c, -1)
    fail(f"{name}: {(d > 0).sum().item()} values differ from the plain "
         f"version; per-channel max |d| {d.amax(dim=1).tolist()}, max "
         f"|value| {want.abs().reshape(c, -1).amax(dim=1).tolist()}")


def kw_plain(kw):
    """`splat`'s keywords less the keys' id bits (its plain version has no
    use for them)."""
    return {k: v for k, v in kw.items() if k != "idx_bits"}


def splat_work(keym_s, vl_s, hp, wp, words, flow_off=False):
    """K2's bytes and operations on a sorted stream (2 samples a segment):
    `words` i32 words a row read, the padded 11-channel accumulator (6
    with `flow_off`) written once; each live sample adds its box
    footprints (a width-W box covers ceil(W) + 1 texels an axis but where
    it lies on texel edges: flowWidth 5 over 5 channels, lineWidth 1 over
    6) at 3 operations a deposit, plus ~80 to derive it."""
    live_samples = 2 * ((vl_s >> 30) & 1).sum().item()
    per_sample = (1 + 1) ** 2 * 6 + (0 if flow_off else (5 + 1) ** 2 * 5)
    deposits = live_samples * per_sample
    planes = 6 if flow_off else 11
    return (4 * words * keym_s.numel() + planes * hp * wp * 4 + 128,
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
                       grid_hw, pscale, p0=None, rgba=None, exact=False,
                       flow_off=False, adds_rows=None, reduce=None):
    """K2 on one sorted stream in every variant (words the stream lacks
    made up: p0 by `p0_words`, rgba8 seeded), each equal to `splat_plain`
    (both sum in int64 at the same fixed-point steps) and the same bits
    on a second call with the same inputs. Prints the partition the kernels ran
    on the stream's own variant (`draw_cuda.splat_planned`), its tile
    ranges held to `torch.searchsorted`: rows a key tile and an output
    tile's source rows (max, median), the split tiles and the
    samples the stray pass added; that variant's int64 sums must equal
    `splat_sums_plain`'s. With `exact`, the
    stream's own variant also within 1e-5 of each channel's max of
    `exact_splat`, the plain version's distance from it printed beside.
    `flow_off`, `adds_rows` and `reduce` are a recorded call's own: the
    streams held here are of single-device frames with the flow on (the
    view-only launch has `check_view_only_kernels`; `adds_rows` and the
    sum over ranks phase 17). Returns `({variant: max |d|}, strays, split
    tiles)`."""
    from tendrils_tpu_torch.ops import draw_cuda
    if flow_off:
        fail(f"K2 ({label}): a view-only call where the flow is on")
    n = p1.numel()
    if reduce is not None or adds_rows not in (None, n):
        fail(f"K2 ({label}): a sharded call (adds_rows {adds_rows}, a "
             "reduction) where one device drew")
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
        errs[name] = equal_to_plain(f"{name} ({label})", got, want)
        again = draw_cuda.splat(scal, keym_s, p1, vl, p0=v_p0, rgba=v_rgba,
                                **kw)
        if not torch.equal(got, again):
            fail(f"{name} ({label}): two calls on one input differ in "
                 f"{(got != again).sum().item()} texels")
        del got, want, again
    sums, info, queue = draw_cuda.splat_planned(
        scal, keym_s, p1, vl, p0=p0, rgba=rgba, **kw)
    if not torch.equal(sums, draw_cuda.splat_sums_plain(
            scal, p1, vl, p0=p0, rgba=rgba, **kw_plain(kw))):
        fail(f"K2 ({label}): the int64 sums differ from the plain "
             "version's")
    del sums
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
    chunk = draw_cuda.split_chunk(n, info.shape[0])
    split = (info[:, 6] > 1).sum().item()
    queued, strays = queue[:2].tolist()
    if queued > draw_cuda.queue_cap(n, chunk) or (split == 0) != (queued == 0):
        fail(f"K2 ({label}): {queued} parts queued for {split} split tiles "
             f"(room for {draw_cuda.queue_cap(n, chunk)})")
    print(f"  K2 on the {label} ({n} rows, gather bits {idx_bits}): every "
          f"variant the same bits on two calls, equal to the plain "
          f"version "
          f"(max |d| " + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
          + f"); rows a key tile max {rows.max().item():.0f}, median "
          f"{rows.median().item():.0f}; an output tile's source rows max "
          f"{work.max().item():.0f}, median "
          f"{work.median().item():.0f}, {split} of {info.shape[0]} tiles "
          f"split (> {chunk}) into {queued} parts; {strays} of "
          f"{samples * n} samples stray; int64 sums equal the plain "
          "version's")
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
    return errs, strays, split


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
    errs = check_splat_stream("seeded config-2 stream", *args, **kw)[0]
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

    # K4 with live targets: also reads tx, ty (8 B a row) and writes the
    # targets (16 B a row). The targets are a copy: equal to the plain
    # version's; the rest equal to K4's without them.
    targs = (*args, *target_streams(n, 0))
    got = gather_cuda.gather_reconstruct_p1(*targs, **kw)
    want = gather_cuda.gather_reconstruct_plain(*targs, **kw)
    equal("gather_reconstruct_targets: targets", got[3], want[3])
    for a, b in zip(got[:3], gather_cuda.gather_reconstruct_p1(*args, **kw)):
        equal("gather_reconstruct_targets against K4", a, b)
    rec("gather_reconstruct_targets",
        close("gather_reconstruct_targets", got[:3], want[:3]),
        lambda: gather_cuda.gather_reconstruct_p1(*targs, **kw),
        lambda: gather_cuda.gather_reconstruct_plain(*targs, **kw),
        80 * n + 8 * texels, 40 * n)
    del got, want

    # K5 at the particles' positions, plus points on and past the edges.
    pos, vs = s["pos"], s["vs"]
    x = ((pos[0] * vs[0]) * 0.5 + 0.5) * w
    y = ((pos[1] * vs[1]) * 0.5 + 0.5) * h
    check_k5("config 2", eff, *on_edges(x, y, h, w), out)
    # Three channels: a pair, then the last alone (the single-plane kernel).
    grid3 = torch.cat([eff, view[:1]])
    close("bilinear_gather (3 channels)",
          [gather_cuda.bilinear_gather(grid3, x, y)],
          [gather_cuda.bilinear_gather_plain(grid3, x, y)])
    return out


def on_edges(x, y, h, w):
    """`x`, `y` with their first 4 points on and past the grid's edges."""
    x[:4] = torch.tensor([w - 0.5, w, w + 3.0, -2.0], device=x.device)
    y[:4] = torch.tensor([h - 0.5, h, 0.25, h + 5.0], device=y.device)
    return x, y


def k5_library(eff, x, y):
    """K5's library call: `grid_sample` (bilinear, border padding,
    unaligned corners) on the same grid and points, the coordinates
    normalised before."""
    h, w = eff.shape[1:]
    norm = torch.stack([x / w * 2.0 - 1.0, y / h * 2.0 - 1.0],
                       dim=-1)[None, None]
    return lambda: torch.nn.functional.grid_sample(
        eff[None], norm, mode="bilinear", padding_mode="border",
        align_corners=False)


def k5_inputs(name):
    """K5's grid and points at a configuration's shapes, as the engine
    gathers (`engine.initial_force`), their first 4 moved on and past the
    edges, and a random decayed flow of its grid. The points: at config 2
    ("1m-flow") phase 3's seeded positions (`resident_inputs`, seed 0),
    spread over the view; else the particles of `models.build(name)` right
    after its ball spawn (a respawn's positions)."""
    from tendrils_tpu_torch import models
    from tendrils_tpu_torch.ops import flow as flow_ops
    if name == "1m-flow":
        h, w = 1080, 1920
        pos, _, _, _, vs = resident_inputs(np.random.default_rng(0), 1 << 20,
                                           (h, w), 0.01)
        pos, vs = (torch.as_tensor(a, device="cuda") for a in (pos, vs))
    else:
        eng = models.build(name)
        h, w = eng.config.flow_shape
        pos, vs = eng.sim.particles[:2], eng._view_size
        del eng
    x = ((pos[0] * vs[0]) * 0.5 + 0.5) * w
    y = ((pos[1] * vs[1]) * 0.5 + 0.5) * h
    del pos
    eff = flow_ops.flow_decayed(random_flow((h, w), 1000.0), 1000.0 + DT,
                                0.005).contiguous()
    return (eff, *on_edges(x, y, h, w))


def check_k5(label, eff, x, y, out=None):
    """K5 within rtol 1e-5 of its plain version; timed, and against
    `grid_sample` in alternating turns. Reads x, y and the touched texels,
    writes C values a point. With `out`, records its row there."""
    from tendrils_tpu_torch.ops import gather_cuda
    c, h, w = eff.shape
    m = x.numel()
    got = gather_cuda.bilinear_gather(eff, x, y)
    err = close(f"bilinear_gather ({label})", [got],
                [gather_cuda.bilinear_gather_plain(eff, x, y)])
    library = k5_library(eff, x, y)
    lib_err = (library()[0, :, 0] - got).abs().max().item()
    del got
    nbytes = m * (8 + c * 4) + c * 4 * touched_texels(x, y, h, w)
    fn = lambda: gather_cuda.bilinear_gather(eff, x, y)  # noqa: E731
    if out is not None:
        timed_row(out, "bilinear_gather", err, fn,
                  lambda: gather_cuda.bilinear_gather_plain(eff, x, y),
                  nbytes, 20 * m, library_fn=library)
    else:
        ms, call_ms, _ = time_calls(fn)
        b, _ = bound(nbytes, 20 * m)
        print(f"  bilinear_gather ({label}, M = {m}, {h}x{w}): max |d| "
              f"{err:.3e}; device {ms:.4f} ms, call {call_ms:.4f} ms (bound "
              f"{b:.4f} ms by bytes)")
    print(f"  (grid_sample against K5 at {label}: max |d| {lib_err:.3e})")
    against_library(f"bilinear_gather ({label})", fn, library)


def check_k5_configs():
    """K5 at config-3 and config-5 shapes: 4,194,304 points over
    1080x1920 and 16,777,216 over 2160x3840 (a grid of 66 MB, more than
    the H100's 50 MB L2)."""
    for name, label in (("4m-respawn-stress", "config 3"),
                        ("16m-live-show", "config 5")):
        check_k5(label, *k5_inputs(name))
        torch.cuda.empty_cache()


def check_config4_kernels():
    """K6, K8, K9 at config-4 shapes, and K4 == K8 + K6 bit for bit."""
    from tendrils_tpu_torch.ops import draw_cuda, flow as flow_ops
    from tendrils_tpu_torch.ops import gather_cuda, splat_cuda
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
    # K6 with live targets: 68 B a row; every output equal.
    targs = (*args, *target_streams(n, 1))
    k6t = draw_cuda.reconstruct_resident(*targs)
    for a, b in zip(k6t, draw_cuda.reconstruct_resident_plain(*targs)):
        equal("reconstruct_resident_targets", a, b)
    for a, b in zip(k6t, k6):
        equal("reconstruct_resident_targets against K6", a, b)
    rec("reconstruct_resident_targets", 0.0,
        lambda: draw_cuda.reconstruct_resident(*targs),
        lambda: draw_cuda.reconstruct_resident_plain(*targs),
        68 * n, 10 * n)

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
    fused = gather_cuda.gather_reconstruct_p1(eff, s["p1_s"], *targs[:3],
                                              sl_t, *targs[4:], inv_p=inv_p)
    if not all(torch.equal(a, b) for a, b in zip(fused, (k8, *k6t))):
        fail("K4 != K8 + K6, with targets")
    del fused
    texels = touched_texels(*p1_coords(s["p1_s"], inv_p, h, w), h, w)
    rec("gather_keyed_p1", err,
        lambda: gather_cuda.bilinear_gather_keyed_p1(
            eff, s["p1_s"], inv_p=inv_p),
        lambda: gather_cuda.bilinear_gather_keyed_p1_plain(
            eff, s["p1_s"], inv_p=inv_p),
        12 * n + 8 * texels, 20 * n)
    print("  K4 == K8 + K6 bit for bit, without and with targets; the "
          "targets of K4 and K6 equal to their plain versions'")

    # K9 at a pointer frame's samples and at 2 x 262,144 spread samples
    # (`k9_cases`): reads x, y, alpha and 4 payload values (28 B a sample),
    # writes the 6-plane accumulator once; 12 operations a valid corner.
    cases = k9_cases()
    for label, x, y, vals, alpha in reversed(cases):
        sargs = ((h, w), x, y, vals, alpha)
        got = k9_planes(splat_cuda.splat_accumulate(*sargs))
        err = equal_to_plain(
            f"splat_points ({label})", got,
            k9_planes(splat_cuda.splat_accumulate_plain(*sargs)))
        if not torch.equal(got,
                           k9_planes(splat_cuda.splat_accumulate(*sargs))):
            fail(f"splat_points ({label}): two calls on one input differ")
        print(f"  splat_points ({label}): the same bits on two calls")
        del got
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
    check_k9_sequence((h, w), cases)
    return out


def k9_cases():
    """K9's inputs at config 4, `[(label, x, y, values, alpha)]`: a
    pointer frame's samples (4 pointers, paths of the default flowDecay's
    200 ms, 5 crest rows, flow_samples 2: the config-4 path) and 2 x
    262,144 samples spread over the 720x1280 grid and past its edges."""
    from tendrils_tpu_torch.feeds import pointer_lines, trail_ms
    from tendrils_tpu_torch.state import default_state
    from tendrils_tpu_torch.ops import coords, flow as flow_ops, splat
    dev = torch.device("cuda")
    h, w = 720, 1280
    sl, time_ = 0.01, 1000.0
    lines = pointer_lines(4, time_, trail_ms(default_state()["flowDecay"]))
    p0, p1, vel, width = lines.segments(time_, coords.cover_aspect((w, h)),
                                        (h, w))
    t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    payload = flow_ops.flow_payload(t(vel), time_, sl)
    x, y, a = splat.segment_samples(t(p0), t(p1), payload[3], 2, 1, width)
    cases = [("pointer", x, y, torch.repeat_interleave(payload, 2, dim=1),
              a)]
    rng = np.random.default_rng(2)
    m = 2 * 512 * 512
    cases.append(("spread", t(rng.uniform(-2, w + 2, m).astype(np.float32)),
                  t(rng.uniform(-2, h + 2, m).astype(np.float32)),
                  t(rng.uniform(-0.01, 0.01, (4, m)).astype(np.float32)),
                  t(rng.uniform(0, 0.9, m).astype(np.float32))))
    return cases


def k9_planes(r):
    """K9's `(num, wsum, logt)` -> its f32[C + 2, H, W] accumulator."""
    return torch.cat([r[0], r[1][None], r[2][None]])


def check_k9_sequence(grid_hw, cases):
    """K9's kept scratch comes back clean: the calls spread, pointer,
    empty (M = 0), all off the grid, pointer, one after another on the
    kept scratch, each bit-equal to a fresh call on the same input (its
    scratch dropped first); the empty and off-grid calls all zeros; a
    pointer call on a second stream, on a scratch of its own, the same."""
    from tendrils_tpu_torch.ops import splat_cuda
    h, w = grid_hw
    (_, *pointer), (_, *spread) = cases
    dev = pointer[0].device
    empty = [torch.zeros(0, device=dev)] * 2 + [
        torch.zeros((4, 0), device=dev), torch.zeros(0, device=dev)]
    off = [pointer[0] + 2 * w, pointer[1] - 2 * h, *pointer[2:]]
    seq = [("spread", spread), ("pointer", pointer), ("empty", empty),
           ("off the grid", off), ("pointer again", pointer)]
    kept = [k9_planes(splat_cuda.splat_accumulate(grid_hw, *c))
            for _, c in seq]
    for (label, c), got in zip(seq, kept):
        splat_cuda._kept.clear()
        fresh = k9_planes(splat_cuda.splat_accumulate(grid_hw, *c))
        if not torch.equal(got, fresh):
            fail(f"splat_points: the {label} call on the kept scratch "
                 "differs from a fresh call")
    for label, got in zip(("empty", "off the grid"), kept[2:4]):
        if got.any():
            fail(f"splat_points: the {label} call is not all zeros")
    if not torch.equal(kept[1], kept[4]):
        fail("splat_points: the pointer call differs after the sequence")
    before = len(splat_cuda._kept)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        other = k9_planes(splat_cuda.splat_accumulate(grid_hw, *pointer))
    torch.cuda.synchronize()
    if len(splat_cuda._kept) != before + 1 or not torch.equal(other,
                                                              kept[1]):
        fail("splat_points: a call on a second stream did not take a "
             "scratch of its own or differs")
    print("  splat_points: spread, pointer, empty, off-grid, pointer on the "
          "kept scratch each equal a fresh call; empty and off-grid all "
          "zeros; a second stream's call on its own scratch the same")


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
    """A K1 variant and its K2 variant bit-exact against their plain
    versions, timed (the bound counts
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
    err = equal_to_plain(f"splat_{name}", draw_cuda.splat(*args, **kw),
                             draw_cuda.splat_plain(s["scal"], p1_s, vl_s,
                                                   **kw_plain(kw)))
    timed_row(out, "splat_" + name, err, lambda: draw_cuda.splat(*args, **kw),
              lambda: draw_cuda.splat_plain(s["scal"], p1_s, vl_s,
                                            **kw_plain(kw)),
              *splat_work(keym_s, vl_s, hp, wp, words))


def k12_points(p1_s, inv_p, h, w):
    """K12's points: the padded coords of sorted p1 words, clamped as the
    draw's aux contract has them."""
    from tendrils_tpu_torch.ops.tile_geom import PAD_LO_H, PAD_LO_W
    x, y = p1_coords(p1_s, inv_p, h, w)
    return x + PAD_LO_W, y + PAD_LO_H


def k12_library(eff, xs, ys):
    """K12's library call: `grid_sample` (bilinear, zero padding,
    unaligned corners) at the content coords, normalised first."""
    from tendrils_tpu_torch.ops.tile_geom import PAD_LO_H, PAD_LO_W
    _, h, w = eff.shape
    norm = torch.stack([(xs - PAD_LO_W) / w * 2.0 - 1.0,
                        (ys - PAD_LO_H) / h * 2.0 - 1.0], dim=-1)[None, None]
    return lambda: torch.nn.functional.grid_sample(
        eff[None], norm, mode="bilinear", padding_mode="zeros",
        align_corners=False)


def check_slice3_kernels():
    """At config-2 shapes (1,048,576 rows, 1080x1920): K1/K2 with the
    exact p0 and rgba8 streams, K7 and K12 against their plain versions;
    at config-4 shapes (262,144 rows, 720x1280): K1/K2 with key_recon and
    rgba8 (the textured resident frame)."""
    from tendrils_tpu_torch.ops import flow as flow_ops, gather_cuda
    dev = torch.device("cuda")
    n, (h, w) = 1 << 20, (1080, 1920)
    sl, time_ = 0.01, 1000.0
    out = {}
    s = classic_streams(n, (h, w), sl, 3)
    # K1 reads p0, p1, vel, pos (8 B each), mapped (16 B), live, idx (4 B
    # each) a row; K2 the four sorted words.
    check_variant_pack_splat("p0_rgba", n, (h, w), s, 56, out)

    # K7 at the sorted p1 from the decayed flow.
    eff = flow_ops.flow_decayed(random_flow((h, w), time_), time_ + DT,
                                0.005).contiguous()
    p1_s = s["sorted"][1]
    inv_p = 1.0 / s["pscale"]
    inv_sl = 1.0 / torch.full((1,), sl, device=dev)
    check_k7("seeded classic config-2 stream", eff, p1_s, inv_sl,
             inv_p=inv_p, out=out)

    # K12 at the same rows' padded coords: reads xs, ys (8 B a row) and the
    # touched texels, writes 2 values a row.
    xs, ys = k12_points(p1_s, inv_p, h, w)
    k12 = gather_cuda.bilinear_gather_keyed(eff, xs, ys)
    err = close("gather_keyed", [k12],
                [gather_cuda.bilinear_gather_keyed_plain(eff, xs, ys)])
    library = k12_library(eff, xs, ys)
    lib_err = (library()[0, :, 0] - k12).abs().max().item()
    if lib_err > 1e-3 * eff.abs().max().item():
        fail(f"gather_keyed vs grid_sample: max |d| {lib_err:.3e}")
    print(f"  (grid_sample against K12: max |d| {lib_err:.3e})")
    timed_row(out, "gather_keyed", err,
              lambda: gather_cuda.bilinear_gather_keyed(eff, xs, ys),
              lambda: gather_cuda.bilinear_gather_keyed_plain(eff, xs, ys),
              16 * n + 8 * touched_texels(*p1_coords(p1_s, inv_p, h, w),
                                          h, w), 20 * n,
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


def check_k7(label, eff, p1_s, inv_sl, *, inv_p, out=None):
    """K7 within 1 per q15 field of its plain version on one sorted
    stream; prints the words that differ and the device time. Reads p1 (4
    B a row) and the touched texels (2 channels), writes one word a row;
    ~30 operations a row. With `out`, records its row there."""
    from tendrils_tpu_torch.ops import gather_cuda
    from tendrils_tpu_torch.ops.tile_geom import HALF
    _, h, w = eff.shape
    n = p1_s.numel()
    k7 = gather_cuda.bilinear_gather_keyed_q15(eff, p1_s, inv_sl,
                                               inv_p=inv_p)
    ref = gather_cuda.bilinear_gather_keyed_q15_plain(eff, p1_s, inv_sl,
                                                      inv_p=inv_p)
    d = torch.maximum(((k7 & HALF) - (ref & HALF)).abs(),
                      ((k7 >> 15) - (ref >> 15)).abs()).max().item()
    if d > 1:
        fail(f"gather_keyed_q15 ({label}): a q15 field differs by {d}")
    print(f"  gather_keyed_q15 ({label}, {n} rows, {h}x{w}): "
          f"{(k7 != ref).sum().item()} of {n} words differ, each q15 field "
          f"by <= {d}")
    del k7, ref
    fn = lambda: gather_cuda.bilinear_gather_keyed_q15(  # noqa: E731
        eff, p1_s, inv_sl, inv_p=inv_p)
    texels = touched_texels(*p1_coords(p1_s, inv_p, h, w), h, w)
    if out is not None:
        timed_row(out, "gather_keyed_q15", float(d), fn,
                  lambda: gather_cuda.bilinear_gather_keyed_q15_plain(
                      eff, p1_s, inv_sl, inv_p=inv_p),
                  8 * n + 8 * texels, 30 * n)
    else:
        ms, call_ms, _ = time_calls(fn)
        print(f"    device {ms:.4f} ms, call {call_ms:.4f} ms (bound "
              f"{bound(8 * n + 8 * texels, 30 * n)[0]:.4f} ms by bytes)")


def capture_k7(eng, frames):
    """K7's inputs (the decayed flow, the sorted p1, 1 / speedLimit and
    the p1 scale) on the frame after `frames` frames of `eng`."""
    from tendrils_tpu_torch import engine
    (eff, p1_s, inv_sl), kw = capture_frame(
        eng, frames, (engine, "bilinear_gather_keyed_q15"))[
            "bilinear_gather_keyed_q15"]
    return eff, p1_s, inv_sl, kw["inv_p"]


def classic(eng):
    """`eng` with `resident_stream=False`, its derived state re-seeded."""
    eng.config = dataclasses.replace(eng.config, resident_stream=False)
    eng.reseed_derived()
    return eng


def check_state(sim, label, drawn="flow"):
    """Finite state, alive particles and texels with weight in the `drawn`
    grid ("flow"; "view" at flowWeight 0, where nothing draws the flow)."""
    for name in ("particles", "previous", "flow", "view", "force"):
        if getattr(sim, name) is None:
            continue
        if not torch.isfinite(getattr(sim, name)).all():
            fail(f"{label}: non-finite {name}")
    alive = ((sim.particles[0] > -9e5).sum().item())
    grid = sim.flow if drawn == "flow" else sim.view[0]
    texels = (grid[3] > 1e-3).sum().item()
    if alive == 0 or texels == 0:
        fail(f"{label}: {alive} alive particles, {texels} {drawn} texels")
    return alive, texels


def by_id(sim):
    return sim.particles.cpu()[:, torch.argsort(sim.idx.cpu())]


def agree(cpu, gpu, label):
    """The card's state against the CPU's: particles and the carried force
    by identity atol 1e-4; grids by the reference's cross-path tolerance
    (1-px smoothed rtol 5e-2 / atol 2e-2, totals rtol 1e-3: the card's
    and the CPU's f32 functions, such as the noise's, differ in the last
    bits, which a few frames of feedback carry into the deposits; on the
    "xla" backend the f32 scatter also adds in another order)."""
    def smooth(img):
        """The 3x3 box mean, zero-padded (a conv with ones / 9)."""
        return torch.nn.functional.avg_pool2d(img[:, None], 3, stride=1,
                                              padding=1)[:, 0]

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


def same_state(a, b, label, need=("particles", "flow", "view", "force")):
    """Every tensor of two states equal bit for bit (`torch.equal`), those
    of `need` (by default the particles, grids and carried force) among
    them; returns the names."""
    names = []
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if x is None and y is None:
            continue
        if x is None or y is None or not torch.equal(x, y):
            d = "one side None" if x is None or y is None else (
                f"{(x != y).sum().item()} values differ, max |d| "
                f"{(x.double() - y.double()).abs().max().item():.3e}")
            fail(f"replay ({label}): {f.name} differs ({d})")
        names.append(f.name)
    missing = set(need) - set(names)
    if missing:
        fail(f"replay ({label}): no {sorted(missing)} to compare")
    return names


def replay(eng, run, label, need=("particles", "flow", "view", "force")):
    """The replay contract: `run()`, one frame of `eng`, twice from one
    converted state and timer; the two states must be equal bit for bit,
    `need` among the tensors compared (`same_state`). Returns their
    names."""
    from tendrils_tpu_torch import convert
    state, t0 = convert.sim_to_numpy(eng.sim), eng.timer.time
    runs = []
    for _ in range(2):
        eng.sim = convert.sim_from_numpy(state, "cuda")
        eng.timer.time = t0
        run()
        runs.append(eng.sim)
    torch.cuda.synchronize()
    return same_state(*runs, label, need)


def replay_respawn(eng3):
    """Phase 5 at config 3: the resident frame right after a ball respawn,
    replayed; prints the strays and split tiles of its splat (the frame's
    `draw_cuda.splat` call recorded, its partition re-run)."""
    from tendrils_tpu_torch.ops import draw_cuda
    with_merge(eng3, False)
    ball(eng3)
    got = {}
    names = replay(eng3, lambda: got.update(
        capture_frame(eng3, 0, (draw_cuda, "splat"))),
        "4m-respawn-stress after a respawn")
    a, kw = got["splat"]
    if kw.pop("reduce") is not None:
        fail("5: the config-3 frame's splat summed over ranks")
    _, info, queue = draw_cuda.splat_planned(*a, **kw)
    split = (info.reshape(-1, draw_cuda.SPLAT_INFO)[:, 6] > 1).sum().item()
    strays = queue[1].item()
    print(f"[5] 4m-respawn-stress, the resident frame right after a ball "
          f"respawn, replayed: {', '.join(names)} equal bit for bit; its "
          f"splat split {split} tiles, {strays} samples stray")


def replay_io():
    """Phase 5 at config 4: an io frame (camera, 4 pointers: K9) replayed
    from one state with the same `step_draw_io` inputs (the feed's third
    frame's, recorded)."""
    from tendrils_tpu_torch import models
    from tendrils_tpu_torch.feeds import IoFeed
    from tendrils_tpu_torch.ops import cuda_lib
    eng = models.build("optical-flow-driven")
    feed = IoFeed(eng)
    feed.frame(0)
    feed.frame(1)
    _, kw = capture_frame(eng, 0, (eng, "step_draw_io"),
                          run=lambda: feed.frame(2))["step_draw_io"]
    segments = len(kw["segments"][0])
    cuda_lib.reset_counts()
    names = replay(eng, lambda: eng.step_draw_io(**kw), "optical-flow-driven")
    k9 = cuda_lib.launches.get("splat_points", 0)
    if segments == 0 or k9 != 2 * K9:
        fail(f"replay (optical-flow-driven): {segments} pointer segments, "
             f"K9 launched {k9} times")
    print(f"[5] optical-flow-driven io frame ({segments} pointer segments "
          f"through K9, the camera's optical flow), replayed: "
          f"{', '.join(names)} equal bit for bit")


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
    return eng, launches, sec * 1e3


def run_config4():
    """Phase 6: config 4 through the entry points; returns the launch
    counts."""
    from tendrils_tpu_torch import models
    from tendrils_tpu_torch.feeds import DEMO_BLUR, IoFeed
    from tendrils_tpu_torch.ops import cuda_lib
    eng = models.build("optical-flow-driven")
    feed = IoFeed(eng)
    cuda_lib.reset_counts()
    feed.frame(0)
    feed.frame(1)
    torch.cuda.synchronize()
    times = []
    frame_i = itertools.count(2)
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(IO_FRAMES):
            feed.frame(next(frame_i))
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
    # The demo's vignette blur on the same io frame: one warm frame (the
    # level LUT is made on the host at first use), 3 timed.
    feed.blur = DEMO_BLUR
    screens = [feed.frame(next(frame_i))]
    sec_blur = timed_frames(lambda: screens.append(feed.frame(next(frame_i))),
                            3)
    h, w = eng.config.view_res
    if any(tuple(sc.shape) != (4, h, w) or not torch.isfinite(sc).all()
           for sc in screens):
        fail("optical-flow-driven with the demo's blur: a screen of the "
             "wrong shape or not finite")
    sec = statistics.median(times) / IO_FRAMES
    err = agree_io_with_plain()
    runs = ", ".join(f"{t / IO_FRAMES * 1e3:.3f}" for t in times)
    print(f"[6] optical-flow-driven: {frames} step_draw_io frames (480x640 "
          f"u8 camera upload + 4 pointer lines each), launches {launches}, "
          f"no plain calls; {alive} alive, {texels} flow texels; "
          f"{sec * 1e3:.3f} ms/frame, {eng.config.n / sec:.0f} "
          f"particle-steps/s (median of 3 x {IO_FRAMES} frames: {runs} "
          f"ms/frame); with the demo's vignette blur {DEMO_BLUR}, screen "
          f"[4, {h}, {w}] finite, {sec_blur * 1e3:.3f} ms/frame (3 frames "
          f"after a warm one); "
          f"card vs CPU particles max |d| {err:.2e}")
    return launches, sec * 1e3


def check_launches(label, frames, per_frame, launches, plain):
    """Every kernel of `per_frame` launched `frames` x its count, no other
    kernel of the draw's tail or the step, and no plain version."""
    for k in ("pack", "splat", "pack_p0_rgba", "splat_p0_rgba", "pack_rgba",
              "splat_rgba", "resolve", "gather_keyed_q15",
              "gather_reconstruct", "reconstruct_resident", "gather_keyed_p1",
              "splat_points", "pack_g3", "pack_p0_rgba_g2", "reorder_compact",
              "reorder_apply", "splat_view", "splat_rgba_view",
              "splat_p0_rgba_view", "resolve_view",
              "gather_reconstruct_targets", "reconstruct_resident_targets",
              "logic_step"):
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
    if launches.get("bilinear_gather") != K5:  # the first frame's step
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


def capture_frame(eng, frames, *targets, run=None):
    """Run `frames` frames of `eng`, then one more (`run`, by default
    `eng.frame`) whose calls of each `(owner, name)` of `targets` are
    recorded, the last call of each: `{name: (args, kwargs)}`, tensors
    cloned, in tuples too (the script wraps them in place for that frame
    and restores them; the package never does)."""
    for _ in range(frames):
        eng.frame()
    got = {}

    def clone(x):
        if isinstance(x, tuple):
            return tuple(map(clone, x))
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
        (run or eng.frame)()
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


def synthetic_merge(n, n_tiles, idx_bits, churn, seed, heavy=None):
    """A merge's inputs `(key, prev_key, prev_hist)`: a tile-sorted previous
    key stream of `n` rows over `n_tiles` tiles (row r's id bits r mod
    2^idx_bits) and a frame in which `churn` rows, drawn at random, moved
    to another tile (with `heavy`, all to tile `heavy`)."""
    from tendrils_tpu_torch.ops import reorder_cuda as ro
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)

    def draw(lo, hi):
        return torch.randint(lo, hi, (n,), generator=g, device=dev,
                             dtype=torch.int32)

    tiles = torch.sort(draw(0, n_tiles))[0]
    low = torch.arange(n, dtype=torch.int32, device=dev) \
        & ((1 << idx_bits) - 1)
    prev = (tiles << idx_bits) | low
    if heavy is None:
        cand = torch.arange(n, device=dev)
        new = (tiles + draw(1, n_tiles)) % n_tiles
    else:
        cand = (tiles != heavy).nonzero()[:, 0]
        new = torch.full_like(tiles, heavy)
    rows = cand[torch.randperm(cand.numel(), generator=g,
                               device=dev)[:churn]]
    key = prev.clone()
    key[rows] = (new[rows] << idx_bits) | low[rows]
    return key, prev, ro.tile_hist(tiles, n_tiles)


def check_reorder_synthetic(n, n_tiles, idx_bits):
    """K11 on synthetic n-row merges at config 3's tiles: churn at exactly
    the n/8 capacity (`ok`), one row past it (`ok` false), and a tenth of
    the rows moved into one tile (`ok`; the source blocks around that
    tile spread over several destination blocks). Outputs and counts bit
    for bit against the plain version; past the capacity, the slots no
    row reached (n - the counts' sum) are the only ones that may differ,
    as both leave them unwritten."""
    from tendrils_tpu_torch.ops import reorder_cuda as ro
    kw = dict(n_tiles=n_tiles, idx_bits=idx_bits)
    cap = ro.capacity(n)
    cases = (("churn n/8", cap, None, True),
             ("churn n/8 + 1", cap + 1, None, False),
             ("a tenth into one tile", n // 10, n_tiles // 2, True))
    for seed, (label, churn, heavy, want_ok) in enumerate(cases):
        key, prev, hist = synthetic_merge(n, n_tiles, idx_bits, churn,
                                          seed, heavy)
        args, _ = ro.merge_plan(key, prev, hist, **kw)
        got = ro.merge_apply(*args, idx_bits=idx_bits)
        want = ro.merge_apply_plain(*args, idx_bits=idx_bits)
        if not torch.equal(got[2], want[2]):
            fail(f"reorder_apply ({label}): counts differ")
        unreached = n - int(want[2].sum())
        differ = int(((got[0] != want[0]) | (got[1] != want[1])).sum())
        if differ > unreached:
            fail(f"reorder_apply ({label}): {differ} slots differ, "
                 f"{unreached} unreached")
        ok = bool(ro.merge_reorder(key, prev, hist, **kw)[0])
        if ok != want_ok:
            fail(f"merge_reorder ({label}): ok {ok}, want {want_ok}")
        if ok and not torch.equal(got[0] >> idx_bits,
                                  torch.sort(key)[0] >> idx_bits):
            fail(f"merge_reorder ({label}): not sorted by tile")
        print(f"  reorder_apply on {n} synthetic rows, {label} ({churn} "
              f"churned): bit-exact, counts included ({unreached} slots "
              f"unreached), ok {ok}")


def check_gather_mode_packs(out):
    """K1 in gather mode 3 (the resident stream beyond 2^20 rows: key_recon,
    `tile << 19 | id_lo`) and mode 2 (the non-resident draw: exact p0 and
    rgba8, the tile alone) at config-3 shapes, bit for bit; and in mode 3
    with rgba8 colours (`pack_rgba_g3`) at the shapes of the demo's
    quality 2 (4,194,304 rows, 720x1280, a textured colour map), bit for
    bit, with K2's rgba8 variant on its sorted stream (mode-3 keys) equal
    to its plain version."""
    from tendrils_tpu_torch.ops import draw_cuda
    n, hw = 1 << 22, (1080, 1920)
    s = sorted_streams(n, hw, 0.01, 5)
    kw = dict(grid_hw=hw, pscale=s["pscale"], gather=3)
    rows = [("pack_g3", s["pack_args"], kw, 24, 12)]
    c = classic_streams(n, hw, 0.01, 6)
    rows.append(("pack_p0_rgba_g2", c["pack_args"],
                 dict(c["pack_kw"], gather=2), 52, 20))
    hw_demo = DEMO_RES
    d = classic_streams(n, hw_demo, 0.01, 7, exact_p0=False, gather=3)
    rows.append(("pack_rgba_g3", d["pack_args"], d["pack_kw"], 48, 16))
    keym_s, p1_s, vl_s, _, rgba_s = d["sorted"]
    kw2 = dict(idx_bits=d["bits"], samples=2, grid_hw=hw_demo,
               pscale=d["pscale"], rgba=rgba_s)
    equal_to_plain("splat_rgba (mode-3 keys)", draw_cuda.splat(
        d["scal"], keym_s, p1_s, vl_s, **kw2), draw_cuda.splat_plain(
        d["scal"], p1_s, vl_s, **kw_plain(kw2)))
    print("  splat_rgba on pack_rgba_g3's sorted stream (mode-3 keys): "
          "equal to its plain version")
    del keym_s, p1_s, vl_s, rgba_s, kw2
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
        if name.startswith("4m"):
            check_reorder_synthetic(inp["key"].numel(), inp["n_tiles"],
                                    inp["idx_bits"])
        del inp
        if name.startswith("4m"):
            merged = not torch.equal(args[1], torch.sort(args[1])[0])
            split = check_splat_stream(
                "sorted stream of a real config-3 frame (keys in "
                + ("the merge's order" if merged else "the flat sort's")
                + ")", *args, **kw)[2]
            if split == 0:
                fail("K2: the config-3 frame's stream split no tile")
        del args, kw
    check_gather_mode_packs(out)
    return out


# Frames before the late config-5 frame K2 is held on: a 30 s window of
# the 16.7M cells ends about here, the particles drawn into filaments.
LATE_FRAMES = 950


def check_splat_streams():
    """Phase 3's K2 part beyond the seeded streams: the sorted stream of a
    real config-2 frame after 30 frames (flow feedback has clustered the
    particles), a classic p0 stream at config 2 in gather mode 2 with
    a twentieth of its p0 anywhere on the grid (segments across tiles:
    strays), and the sorted stream of a config-5 frame after
    `LATE_FRAMES` frames (16,777,216 rows in filaments)."""
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
    strays = check_splat_stream(
        "classic p0 stream with long segments", c["scal"], keym_s, p1_s,
        vl_s, idx_bits=c["bits"], samples=2, grid_hw=(1080, 1920),
        pscale=c["pscale"], p0=p0_s, rgba=rgba_s)[1]
    if strays == 0:
        fail("K2: the long-segment stream has no strays")
    args, kw = capture_frame(models.build("16m-live-show"), LATE_FRAMES,
                             (draw_cuda, "splat"))["splat"]
    check_splat_stream(f"sorted stream of a config-5 frame after "
                       f"{LATE_FRAMES} frames", *args, **kw)
    del args, kw
    torch.cuda.empty_cache()


def check_view_only_kernels():
    """K2's view-only launch (flow_off) in every variant on config 1's
    seeded stream (65,536 rows, 720x1280) and config 2's (1,048,576,
    1080x1920): equal to its plain version, the same bits on two calls, and bit-equal to planes 5-10 of the 11-channel
    call on the same stream; K3's view-only variant against its plain
    version and bit-equal to the view K3 makes from the 11 channels. The
    config-1 path's variants are timed there."""
    from tendrils_tpu_torch.ops import draw_cuda
    from tendrils_tpu_torch.ops.tile_geom import pad_dims
    dev = torch.device("cuda")
    out = {}
    for label, n, (h, w), timed in (("config-1", 1 << 16, (720, 1280), True),
                                    ("config-2", 1 << 20, (1080, 1920),
                                     False)):
        hp, wp = pad_dims(h, w)
        s = sorted_streams(n, (h, w), 0.01, 2)
        scal, keym_s, p1, vl = s["scal"], s["keym_s"], s["p1_s"], s["vl_s"]
        args = (scal, keym_s, p1, vl)
        kw = dict(idx_bits=20, samples=2, grid_hw=(h, w), pscale=s["pscale"])
        p0_w = p0_words(scal, p1, vl, (h, w), s["pscale"])
        rgba_w = torch.as_tensor(np.random.default_rng(9).integers(
            0, 1 << 31, n).astype(np.int32), device=dev)
        errs = {}
        for name, v_p0, v_rgba in (("splat_view", None, None),
                                   ("splat_rgba_view", None, rgba_w),
                                   ("splat_p0_rgba_view", p0_w, rgba_w)):
            vkw = dict(kw, p0=v_p0, rgba=v_rgba, flow_off=True)
            got = draw_cuda.splat(*args, **vkw)
            errs[name] = equal_to_plain(
                f"{name} ({label})", got,
                draw_cuda.splat_plain(scal, p1, vl, **kw_plain(vkw)))
            if not torch.equal(got, draw_cuda.splat(*args, **vkw)):
                fail(f"{name} ({label}): two calls on one input differ")
            full = draw_cuda.splat(*args, **dict(vkw, flow_off=False))
            if not torch.equal(got, full[draw_cuda.N_FLOW:]):
                fail(f"{name} ({label}): "
                     f"{(got != full[draw_cuda.N_FLOW:]).sum().item()} "
                     "texels differ from the 11-channel call's view planes")
            if timed and name != "splat_rgba_view":
                timed_row(out, name, errs[name],
                          lambda a=args, k=vkw: draw_cuda.splat(*a, **k),
                          lambda k=kw_plain(vkw): draw_cuda.splat_plain(
                              scal, p1, vl, **k),
                          *splat_work(keym_s, vl, hp, wp,
                                      3 if v_p0 is None else 5,
                                      flow_off=True),
                          label=f" ({label}, {n} rows)")
            del got, full
        print(f"  K2 view-only on the seeded {label} stream ({n} rows): every "
              f"variant bit-equal to planes 5-10 of the 11-channel call, the "
              f"same bits on two calls, equal to its plain version (max |d| "
              + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()) + ")")
        if not timed:
            continue
        # K3 view-only: reads the 6 accumulator planes' content and the
        # old view, writes the new view: 56 B a pixel.
        acc = draw_cuda.splat(*args, **kw, flow_off=True)
        full = draw_cuda.splat(*args, **kw)
        view = torch.rand((4, h, w), device=dev)
        rscal = draw_cuda._resolve_scal(
            torch.tensor([0.1333, 0.1333, 0.1333, 0.05], device=dev), 0.0,
            1000.0, 1000.0 + DT, 0.005, 5.0, 1.0, dev)
        got = draw_cuda.resolve_view(rscal, acc, view)
        err = close("resolve_view", [got],
                    [draw_cuda.resolve_view_plain(rscal, acc, view)])
        if not torch.equal(got, draw_cuda.resolve(
                rscal, full, random_flow((h, w), 1000.0), view)[1]):
            fail("resolve_view: differs from K3's view on the 11 channels")
        print("  K3 view-only: bit-equal to the view K3 makes from the 11 "
              "channels")
        timed_row(out, "resolve_view", err,
                  lambda: draw_cuda.resolve_view(rscal, acc, view),
                  lambda: draw_cuda.resolve_view_plain(rscal, acc, view),
                  56 * h * w, 20 * h * w, label=f" ({label})")
    return out


# K13, the logic step: bytes a particle (the particles f32[4], the targets'
# xy f32[2], the flow force f32[2] and the ids i32 read once, the particles
# f32[4] written once; `frame_profile.py` reads it too), the frames stepped
# and drawn before its second check, and the H100 SXM's warp instructions an
# SM can issue a clock (4 schedulers).
LOGIC_BYTES = 52
LOGIC_FRAMES = 3
ISSUE_PER_SM_CLOCK = 4
# A particle grid whose side is no power of two, so that 1 / root_num is
# not exact (1,000,000 particles at config 2's view).
LOGIC_ODD_ROOT = 1000


def ulp_gap(got, want):
    """The largest gap between two f32 tensors in units in the last place
    (0: equal bit for bit)."""
    def ordered(t):
        i = t.view(torch.int32).long()
        return torch.where(i < 0, -(i & 0x7FFFFFFF), i)
    return int((ordered(got) - ordered(want)).abs().max().item())


def logic_cases(eng):
    """K13's arguments on the engine's state for each force source it
    takes: the carried force (where the state carries one), K5's gather
    from the flow (`engine._step_force`), and none with flowWeight 0
    (`flow_off`)."""
    from tendrils_tpu_torch import engine as engine_mod
    sim, params = eng.sim, eng.params()
    time_ = engine_mod.device_f32(eng.timer.time, "cuda")
    dt = engine_mod.device_f32(DT, "cuda")
    forces = {} if sim.force is None else {"carried": (sim.force, params)}
    forces["gathered"] = (engine_mod._step_force(
        sim, params, time_, eng.config, eng._view_size), params)
    forces["flow_off"] = (None, dict(params, flowWeight=torch.zeros(
        (), device="cuda")))
    return {k: (sim.particles, sim.targets, sim.idx, f, p, time_, dt,
                eng.config.root_num) for k, (f, p) in forces.items()}


def check_logic_state(label, eng):
    """K13 equal to its plain version on the card bit for bit, on the
    engine's state, for each force source; returns the sources."""
    from tendrils_tpu_torch.ops import logic_cuda
    cases = logic_cases(eng)
    for source, args in cases.items():
        got = logic_cuda.logic_step(*args)
        want = logic_cuda.logic_step_plain(*args)
        gap = ulp_gap(got, want)
        if gap:
            words = (got.view(torch.int32) != want.view(torch.int32)).sum()
            fail(f"logic_step ({label}, {source}): {words.item()} words "
                 f"differ from its plain version, by up to {gap} ulps")
    return list(cases)


def sass_stats(kernel):
    """`(instructions, {opcode: count}, resources)` of `kernel` in the built
    library, read with cuobjdump beside nvcc: its SASS instructions (NOPs
    aside; a loop's body once) and its registers, stack and local memory;
    None where cuobjdump fails."""
    import pathlib
    import re
    from tendrils_tpu_torch.ops import cuda_lib
    tool = str(pathlib.Path(cuda_lib._nvcc()).with_name("cuobjdump"))
    so = cuda_lib.library()._name
    try:
        sass = subprocess.run([tool, "-sass", so], capture_output=True,
                              text=True, check=True).stdout
        res = subprocess.run([tool, "-res-usage", so], capture_output=True,
                             text=True, check=True).stdout
    except (OSError, subprocess.CalledProcessError):
        return None
    ops = collections.Counter()
    for block in sass.split("Function : ")[1:]:
        if kernel in block.splitlines()[0]:
            for m in re.finditer(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?"
                                 r"([A-Z][A-Z0-9]*)", block):
                if m.group(1) != "NOP":
                    ops[m.group(1)] += 1
    lines = res.splitlines()
    used = next((lines[i + 1].strip() for i, line in enumerate(lines[:-1])
                 if kernel in line), "not found")
    return sum(ops.values()), ops, used


def sm_clock_hz():
    """The card's highest SM clock (nvidia-smi), in Hz; None if unread."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.max.sm",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, check=True).stdout.split()
        return float(out[0]) * 1e6
    except (OSError, subprocess.CalledProcessError, ValueError, IndexError):
        return None


def kernel_ms_in(fn, kernel, reps=5):
    """Device ms a launch of the kernels named `kernel` among all that
    `reps` calls of `fn` (a frame) launch, by `torch.profiler`; None if the
    trace holds none. A frame's trace holds events no runtime call of its
    own asked for (`time_calls` refuses it), so only `kernel`'s are read."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    hits = [ev for ev in prof.key_averages()
            if ev.device_type == torch.autograd.DeviceType.CUDA
            and kernel in ev.key]
    count = sum(ev.count for ev in hits)
    return sum(ev.self_device_time_total for ev in hits) / 1e3 / count \
        if count else None


def check_logic_kernel():
    """Phase 3's K13 rows: the logic step equal to its plain version bit
    for bit at config-2 and config-5 shapes (1,048,576 and 16,777,216
    particles) right after the ball spawn (K5's gather, flow_off) and
    after LOGIC_FRAMES frames (the carried force too), and at a root of
    LOGIC_ODD_ROOT; at config 5 timed warm, cold after a write and after
    a read, and in a frame, beside its bound at LOGIC_BYTES a particle and
    the issue time of its SASS. Returns its row."""
    import tendrils_tpu_torch as tt
    from tendrils_tpu_torch import models
    from tendrils_tpu_torch.models.configs import _spawned
    from tendrils_tpu_torch.ops import logic_cuda
    out = {}
    odd = lambda: _spawned(tt.EngineConfig(  # noqa: E731
        root_num=LOGIC_ODD_ROOT, view_res=(1080, 1920), flow_samples=2,
        flow_rows=1, view_samples=2))
    for label, build in (("config 2", lambda: models.build("1m-flow")),
                         (f"root {LOGIC_ODD_ROOT}", odd),
                         ("config 5", lambda: models.build("16m-live-show"))):
        eng = build()
        spawned = check_logic_state(f"{label}, spawned", eng)
        for _ in range(LOGIC_FRAMES):
            eng.frame()
        stepped = check_logic_state(f"{label}, {LOGIC_FRAMES} frames", eng)
        n = eng.config.n
        print(f"  logic_step ({label}, {n} particles): equal to its plain "
              f"version bit for bit, spawned ({', '.join(spawned)}) and "
              f"after {LOGIC_FRAMES} frames ({', '.join(stepped)})")
        if label != "config 5":
            del eng
            torch.cuda.empty_cache()
    args = logic_cases(eng)["carried"]
    timed_row(out, "logic_step", 0.0, lambda: logic_cuda.logic_step(*args),
              lambda: logic_cuda.logic_step_plain(*args), LOGIC_BYTES * n, 0,
              label=" (config 5, the carried force)")
    row = out["logic_step"]
    in_frame = kernel_ms_in(eng.frame, "logic_step_kernel")
    row["frame_ms"] = in_frame
    b = row["bound_ms"]
    shares = " / ".join(
        "not measured" if ms is None else f"{100 * b / ms:.1f} %"
        for ms in (row["ms"], row["cold_ms"], row["cold_clean_ms"],
                   in_frame))
    print(f"  logic_step in a config-5 frame: "
          + ("not measured" if in_frame is None else f"{in_frame:.4f} ms")
          + f"; its bound at {LOGIC_BYTES} B a particle {b:.4f} ms; share of "
          f"the bound warm / after a write / after a read / in a frame: "
          f"{shares}")
    stats, clock = sass_stats("logic_step_kernel"), sm_clock_hz()
    if stats is None or clock is None:
        print("  logic_step SASS or SM clock not read: issue time not "
              "estimated")
    else:
        count, ops, used = stats
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        issue_ms = count * -(-n // 32) / (sms * ISSUE_PER_SM_CLOCK * clock) \
            * 1e3
        print(f"  logic_step SASS: {count} instructions a thread ("
              + ", ".join(f"{k} {v}" for k, v in ops.most_common(12))
              + f"); {used}; issue time at {n} particles on {sms} SMs at "
              f"{clock / 1e9:.3f} GHz: {issue_ms:.4f} ms, beside the bytes' "
              f"{b:.4f} ms")
    del eng
    torch.cuda.empty_cache()
    return out


def path_b_k7():
    """K7's inputs on path B: the paused `frame()` at config 4 with the
    demo's colour maps (262,144 rows, 720x1280), after 2 running io
    frames."""
    from tendrils_tpu_torch import models
    from tendrils_tpu_torch.feeds import IoFeed
    eng = models.build("optical-flow-driven")
    feed = IoFeed(eng, color_maps=True)
    feed.frame(0)
    feed.frame(1)
    eng.timer.paused = True
    return capture_k7(eng, 0)


def check_k7_real_frame():
    """Phase 3's K7 on the sorted stream of a real classic config-2 frame
    after 30 frames (flow feedback has clustered the particles; the keys
    are the segments' tiles, so a row's p1 may lie a tile row below), and
    on path B's."""
    from tendrils_tpu_torch import models
    eff, p1_s, inv_sl, inv_p = capture_k7(classic(models.build("1m-flow")),
                                          30)
    check_k7("real classic config-2 frame after 30 frames", eff, p1_s,
             inv_sl, inv_p=inv_p)
    eff, p1_s, inv_sl, inv_p = path_b_k7()
    check_k7("paused config-4 frame() with colour maps (path B)", eff, p1_s,
             inv_sl, inv_p=inv_p)


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
    if launches.get("bilinear_gather") != 2 * K5 \
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
        if launches.get("bilinear_gather") != 3 * K5:
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
    paused `frame()` (gather mode 2, K7). Returns the launch counts, the
    config-5 engine and its headless ms/frame with the merge off."""
    from tendrils_tpu_torch import models
    from tendrils_tpu_torch.ops import cuda_lib
    total = {}

    def add(launches):
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v

    cuda_lib.reset_counts()
    k7_args = capture_k7(classic(eng3), 0)
    add(dict(cuda_lib.launches))
    check_launches("4m-respawn-stress classic", 1, CLASSIC_G2,
                   dict(cuda_lib.launches), dict(cuda_lib.plain_calls))
    carry_ok(eng3.sim, eng3.config, "4m-respawn-stress classic")
    if eng3.sim.force is None:
        fail("4m-respawn-stress classic: no carried force")
    check_k7("config 3's gather-mode-2 classic frame", *k7_args[:3],
             inv_p=k7_args[3])
    del k7_args
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
        if launches.get("bilinear_gather") != K5:
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
    return total, eng, med[False] * 1e3


def config1():
    """BASELINE config 1 as `bench.py:180-186` builds it: 256² particles
    at 720x1280, 2 flow and view samples, a ball spawn, then
    `flowWeight = 0`."""
    from tendrils_tpu_torch import models
    eng = models.build("default-preview", view_res=(720, 1280))
    eng.state["flowWeight"] = 0.0
    return eng


def flow_off_contract(eng):
    """JAX's contract (tests/test_carry_force.py:177-227) on the card: from
    one converted state at flowWeight 0, 4 frames with the gate and 4 with
    it forced off give particles equal by identity and views equal bit for
    bit; gated, the flow grid is untouched and no force is carried. `eng`
    is left with the gated run's state and timer."""
    from tendrils_tpu_torch import convert, engine as tengine
    state, t0 = convert.sim_to_numpy(eng.sim), eng.timer.time
    runs = []
    for flow_off in (True, False):
        eng.sim = convert.sim_from_numpy(state, "cuda")
        eng.timer.time = t0
        for _ in range(4):
            eng.timer.tick()
            x = eng._frame_inputs()
            eng.sim = tengine._frame(
                eng.sim, x.params, x.time, x.dt, eng.config, eng._view_size,
                targets_live=False, fast_resolve=x.fast_resolve,
                flow_off=flow_off, host_widths=x.host_widths)
        runs.append(eng.sim)
    a, b = runs
    if not torch.equal(by_id(a), by_id(b)):
        fail(f"config 1 contract: particles differ by "
             f"{(by_id(a) - by_id(b)).abs().max().item():.3e}")
    if not torch.equal(a.view, b.view):
        fail("config 1 contract: views differ in "
             f"{(a.view != b.view).sum().item()} values")
    if not torch.equal(a.flow.cpu(), torch.as_tensor(state["flow"])) \
            or a.force is not None:
        fail("config 1 contract: the gated frames moved the flow grid or "
             "carried a force")
    eng.sim = a


def agree_config1():
    """Config 1's frame: a small run (root 64, 720x1280, flowWeight 0) on
    the card against the same run on the CPU, 3 frames."""
    cpu, gpu = spawned_pair((720, 1280))
    for eng in (cpu, gpu):
        eng.state["flowWeight"] = 0.0
    for _ in range(3):
        cpu.frame()
        gpu.frame()
    return agree(cpu, gpu, "default-preview, flowWeight 0")


def run_config1():
    """Phase 12: config 1 through the entry points, flowWeight 0: two
    facade frames and `run_headless` for STEPS steps (resident), then one
    classic frame; returns the launch counts of that run."""
    import tendrils_tpu_torch as tt
    from tendrils_tpu_torch.ops import cuda_lib
    eng = config1()
    flow0 = eng.sim.flow.clone()
    cuda_lib.reset_counts()
    eng.frame()
    eng.frame()
    eng.sim = tt.run_headless(eng.sim, eng.params(), eng.config,
                              eng._view_size, eng.timer.time, DT, STEPS,
                              targets_live=False, flow_off=True)
    eng.timer.time += STEPS * DT
    torch.cuda.synchronize()
    launches = dict(cuda_lib.launches)
    check_launches("config 1 resident", 2 + STEPS, CONFIG1_RESIDENT,
                   launches, dict(cuda_lib.plain_calls))
    classic(eng)
    cuda_lib.reset_counts()
    eng.frame()
    torch.cuda.synchronize()
    check_launches("config 1 classic", 1, CONFIG1_CLASSIC,
                   dict(cuda_lib.launches), dict(cuda_lib.plain_calls))
    for k, v in cuda_lib.launches.items():
        launches[k] = launches.get(k, 0) + v
    if launches.get("bilinear_gather", 0):
        fail(f"config 1: K5 launched (launches {launches})")
    if not torch.equal(eng.sim.flow, flow0) or eng.sim.force is not None:
        fail("config 1: the flow grid moved or a force was carried")
    alive, texels = check_state(eng.sim, "config 1", drawn="view")
    flow_off_contract(eng)
    eng.config = dataclasses.replace(eng.config, resident_stream=True)
    eng.reseed_derived()
    flow_off_contract(eng)
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.sim = tt.run_headless(eng.sim, eng.params(), eng.config,
                                  eng._view_size, eng.timer.time, DT, STEPS,
                                  targets_live=False, flow_off=True)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        eng.timer.time += STEPS * DT
    check_state(eng.sim, "config 1 timed", drawn="view")
    if not torch.equal(eng.sim.flow, flow0):
        fail("config 1 timed: the flow grid moved")
    sec = statistics.median(times) / STEPS
    err = agree_config1()
    runs = ", ".join(f"{t / STEPS * 1e3:.3f}" for t in times)
    print(f"[12] config 1 (default-preview at 720x1280, flowWeight 0): 2 "
          f"frames + {STEPS} headless steps + 1 classic frame, launches "
          f"{launches}, no plain calls, no K4, K5 or K7; the flow grid "
          f"frozen bit for bit; {alive} alive, {texels} view texels; 4 "
          f"frames gated and ungated from one state give the same particles "
          f"and view bit for bit (classic and resident); "
          f"{sec * 1e3:.3f} ms/frame, {eng.config.n / sec:.0f} "
          f"particle-steps/s (median of 3 x {STEPS} steps: {runs} ms/frame); "
          f"card vs CPU particles max |d| {err:.2e}")
    return launches


def quantile(d, q):
    """The q-quantile of every value of `d` (sorted; `torch.quantile`
    refuses tensors past 2^24 values)."""
    flat = torch.sort(d.flatten())[0]
    return flat[int(q * (flat.numel() - 1))].item()


def bokeh_against_f64(view):
    """Bokeh alone on `view` (4K) in the blur stack's one form, the
    windowed boxes: `(max |d|, p99.9)` against the same bokeh in float64
    on the card, and its device and call ms (5 calls). It must stay
    within the JAX module's cross-form bounds (max 5e-3, p99.9 2e-3) and
    within BOKEH_F32_MAX, which a stack in TF32 or bf16 misses."""
    from tendrils_tpu_torch.ops import post
    ref = post.bokeh(view.double(), *SHOW_BOKEH)
    d = (post.bokeh(view, *SHOW_BOKEH).double() - ref).abs()
    mx, p999 = d.max().item(), quantile(d, 0.999)
    del d
    ms, call_ms, _ = time_calls(lambda: post.bokeh(view, *SHOW_BOKEH),
                                reps=5)
    if mx >= BOKEH_F32_MAX:
        fail(f"bokeh (boxes) against float64: max |d| {mx:.3e}, over "
             f"{BOKEH_F32_MAX:.0e}")
    if mx >= 5e-3 or p999 >= 2e-3:
        fail(f"bokeh (boxes) against float64: max |d| {mx:.3e}, p99.9 "
             f"{p999:.3e}")
    return mx, p999, ms, call_ms


def show_frame(eng, i):
    """Config 5's show frame (`bench.py:352-378`): the audio-style
    `noiseScale` modulation, a tick, and the io frame with bokeh."""
    eng.state["noiseScale"] = 2.0 + 0.5 * (i % 3)
    eng.timer.tick()
    return eng.step_draw_io(bokeh=SHOW_BOKEH)


def run_show_frame(eng, headless_ms):
    """Phase 13: config 5's show frame uncut on phase 10's engine (merge
    off): 2 warm frames and 3 timed runs of SEG, the screen `[4, 2160,
    3840]` and finite; then bokeh alone (`bokeh_against_f64`)."""
    from tendrils_tpu_torch.ops import cuda_lib
    with_merge(eng, False)
    cuda_lib.reset_counts()
    screen = show_frame(eng, 0)
    show_frame(eng, 1)
    frames = itertools.count(2)
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(SEG):
            screen = show_frame(eng, next(frames))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) / SEG)
    launches = dict(cuda_lib.launches)
    per = dict(CONFIG3_OFF, bilinear_gather=0)
    per["pack_g3"] = per.pop("pack")
    check_launches("16m-live-show show frame", 2 + 3 * SEG, per, launches,
                   dict(cuda_lib.plain_calls))
    h, w = eng.config.view_res
    if tuple(screen.shape) != (4, h, w) or not torch.isfinite(screen).all():
        fail(f"show frame: screen {tuple(screen.shape)}, finite "
             f"{torch.isfinite(screen).all().item()}")
    alive, texels = check_state(eng.sim, "16m-live-show show frame")
    mx, p999, ms, call_ms = bokeh_against_f64(eng.sim.view[0].contiguous())
    sec = statistics.median(times)
    print(f"[13] 16m-live-show show frame, step_draw_io(bokeh={SHOW_BOKEH}) "
          f"every frame: {2 + 3 * SEG} frames, launches {launches}, no plain "
          f"calls; screen {tuple(screen.shape)} finite; {alive} alive, "
          f"{texels} flow texels; {sec * 1e3:.3f} ms/frame (3 x {SEG}: "
          f"{', '.join(f'{t * 1e3:.3f}' for t in times)}) against "
          f"{headless_ms:.3f} headless (phase 10, merge off)")
    print(f"  bokeh alone at {h}x{w}, boxes: against float64 max |d| "
          f"{mx:.3e}, p99.9 {p999:.3e}; device {ms:.4f} ms, call "
          f"{call_ms:.4f} ms")
    return launches


def camera_grid(i=0):
    """The synthetic 480x640 camera frame `i` (`feeds.camera_frame`) as
    the engine grid `f32[4, 480, 640]` the demo spawns from."""
    from tendrils_tpu_torch.feeds import camera_frame
    from tendrils_tpu_torch.media import image_to_grid
    return image_to_grid(camera_frame(i))


def image_spawner(shader):
    """One of the demo's camera spawners (`app/demo.py:110-115`): X
    flipped."""
    from tendrils_tpu_torch.spawners import PixelSpawner
    sp = PixelSpawner(shader=shader)
    sp.spawn_matrix[0, 0] = -1
    return sp


def spawn_image(eng, sp, grid, target):
    """The demo's `_spawn_raster` (`app/demo.py:492-510`) from a camera
    grid: speed 0.3, the pixels and the colour map set, then the spawn."""
    sp.speed = 0.3
    sp.set_pixels(grid)
    eng.set_color_map(grid)
    sp.spawn(eng, target=target)


def spawn_image_targets(eng, sp, grid):
    """The demo's `spawn_image_targets` (`app/demo.py:517-521`): a target
    spawn, then a plain spawn, from the camera."""
    spawn_image(eng, sp, grid, "targets")
    spawn_image(eng, sp, grid, None)


def targets_by_id(sim):
    return sim.targets[:, torch.argsort(sim.idx)]


def check_targets(sim, spawned, label):
    """The live targets by identity: the spawned xy bit for bit, zeros
    below (K4's and K6's re-stack)."""
    got = targets_by_id(sim)
    if not torch.equal(got[:2], spawned[:2]):
        fail(f"{label}: {(got[:2] != spawned[:2]).sum().item()} target "
             "values moved")
    if got[2:].any():
        fail(f"{label}: the targets' velocity rows are not zero")


def time_spawn(label, fn, rows):
    """A spawn's device ms and call ms (`time_calls`, 5 calls; plain
    torch, so a trace that keeps losing events leaves the device ms "not
    measured")."""
    ms, call_ms, _ = time_calls(fn, reps=5, strict=False)
    dev = "not measured" if ms is None else f"{ms:.4f} ms"
    print(f"  {label} spawn at {rows:,} rows: device {dev}, call "
          f"{call_ms:.4f} ms")
    return dev


def targets_in_turns(eng, sim, steps, t_sim, rounds=3):
    """ms/frame of `run_headless` from one state `sim` (no force) with the
    targets riding and not, in `rounds` alternating turns (on, off, ...):
    what riding them costs, the state held fixed. Returns the medians
    `{True: on, False: off}` and the turns' times."""
    import tendrils_tpu_torch as tt
    times = {True: [], False: []}
    for _ in range(rounds):
        for live in (True, False):
            start = dataclasses.replace(sim, force=None)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tt.run_headless(start, eng.params(), eng.config, eng._view_size,
                            t_sim, DT, steps, targets_live=live)
            torch.cuda.synchronize()
            times[live].append((time.perf_counter() - t0) / steps)
    return {k: statistics.median(v) for k, v in times.items()}, times


def turns_line(med, times):
    return (f"{med[True] * 1e3:.3f} ms/frame with the targets riding and "
            f"{med[False] * 1e3:.3f} without, from one state in "
            f"{len(times[True])} alternating turns (with: "
            f"{', '.join(f'{t * 1e3:.3f}' for t in times[True])}; "
            f"without: {', '.join(f'{t * 1e3:.3f}' for t in times[False])})")


def run_spawns_config2(headless_ms):
    """Phase 14 at config 2: the demo's spawners, then live targets through
    the facade and `run_headless`, timed beside phase 4's figure; the card
    against the CPU. Returns the launch counts."""
    import tendrils_tpu_torch as tt
    from tendrils_tpu_torch import models
    from tendrils_tpu_torch.ops import cuda_lib
    from tendrils_tpu_torch.spawners import GeometrySpawner, PixelSpawner
    eng = models.build("1m-flow")
    n = eng.config.n
    cuda_lib.reset_counts()
    eng.frame()
    eng.frame()
    grid = camera_grid(0)
    flow_sp = PixelSpawner(shader="flow-sample")
    data_sp = PixelSpawner(shader="data-sample")
    geom = GeometrySpawner(speed=0.005, bias=1e2 / 5e-3)
    direct, sample = image_spawner("direct"), image_spawner("best-sample")
    direct.speed, sample.speed = 0.3, 1.0
    direct.set_pixels(grid)
    sample.set_pixels(grid)
    flow_sp.set_pixels(eng.sim.flow)
    data_sp.set_pixels(eng.sim.particles.reshape(4, eng.config.root_num,
                                                 eng.config.root_num))
    spawns = (("flow-sample", lambda: flow_sp.spawn(eng)),
              ("data-sample", lambda: data_sp.spawn(eng)),
              ("GeometrySpawner.shuffle()", lambda: geom.shuffle().spawn(
                  eng)),
              ("direct (camera)", lambda: direct.spawn(eng)),
              ("best-sample (camera)", lambda: sample.spawn(eng)))
    for label, fn in spawns:
        time_spawn(label, fn, n)
        k5 = cuda_lib.launches["bilinear_gather"]
        eng.frame()
        torch.cuda.synchronize()
        if cuda_lib.launches["bilinear_gather"] != k5 + K5:
            fail(f"1m-flow after the {label} spawn: the frame did not "
                 "gather its force with K5")
        check_state(eng.sim, f"1m-flow after the {label} spawn")

    eng.state["target"] = 0.003
    parts = eng.sim.particles.clone()
    time_spawn("direct target (camera)",
               lambda: direct.spawn(eng, target="targets"), n)
    if not eng._targets_live or not torch.equal(eng.sim.particles, parts):
        fail("1m-flow target spawn: the targets are not live, or the "
             "particles moved")
    spawned = targets_by_id(eng.sim).clone()
    cuda_lib.reset_counts()
    eng.frame()
    eng.frame()
    eng.sim.force = None
    sim = tt.run_headless(eng.sim, eng.params(), eng.config, eng._view_size,
                          eng.timer.time, DT, STEPS, targets_live=True)
    torch.cuda.synchronize()
    launches = dict(cuda_lib.launches)
    per = dict(CONFIG3_OFF, gather_reconstruct_targets=1)
    del per["gather_reconstruct"]
    check_launches("1m-flow live targets", 2 + STEPS, per, launches,
                   dict(cuda_lib.plain_calls))
    if launches.get("bilinear_gather") != K5:
        fail(f"1m-flow live targets: launches {launches}")
    check_targets(sim, spawned, "1m-flow live targets")
    alive, texels = check_state(sim, "1m-flow live targets")
    times = []
    t_sim = eng.timer.time + STEPS * DT
    for _ in range(3):
        sim.force = None
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sim = tt.run_headless(sim, eng.params(), eng.config, eng._view_size,
                              t_sim, DT, STEPS, targets_live=True)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        t_sim += STEPS * DT
    check_targets(sim, spawned, "1m-flow live targets, timed")
    check_state(sim, "1m-flow live targets, timed")
    med, turns = targets_in_turns(eng, sim, STEPS, t_sim)
    eng.sim, eng.timer.time = sim, t_sim
    sec = statistics.median(times) / STEPS
    err = agree_targets_with_plain(grid)
    print(f"[14] 1m-flow with live targets (target 0.003): 2 frames + "
          f"{STEPS} run_headless(targets_live=True) steps, launches "
          f"{launches}, no plain calls; the targets by identity the spawned "
          f"xy bit for bit, their velocity rows zero; {alive} alive, "
          f"{texels} flow texels; {sec * 1e3:.3f} ms/frame (median of 3 x "
          f"{STEPS}: {', '.join(f'{t / STEPS * 1e3:.3f}' for t in times)}) "
          f"against {headless_ms:.3f} without targets (phase 4); "
          f"{turns_line(med, turns)}; card vs CPU particles max |d| "
          f"{err:.2e}, targets equal")
    return eng, launches


def agree_targets_with_plain(grid):
    """Config 2 with live targets: a small run on the card against the same
    run on the CPU from one target spawn (made on the CPU), 3 frames; the
    targets equal by identity on both."""
    from tendrils_tpu_torch import convert
    cpu, gpu = spawned_pair((1080, 1920))
    for eng in (cpu, gpu):
        eng.state["target"] = 0.003
    spawn_image(cpu, image_spawner("direct"), grid, "targets")
    gpu.config, gpu.timer.time = cpu.config, cpu.timer.time
    gpu.sim = convert.sim_from_numpy(convert.sim_to_numpy(cpu.sim), "cuda")
    gpu._targets_live = True
    for _ in range(3):
        cpu.frame()
        gpu.frame()
    if not torch.equal(targets_by_id(cpu.sim),
                       targets_by_id(gpu.sim).cpu()):
        fail("1m-flow live targets card vs CPU: the targets differ")
    return agree(cpu, gpu, "1m-flow live targets")


def run_targets_config5(eng, headless_ms):
    """Phase 14 at config 5 on phase 10's engine (merge off, gather mode
    3): a direct target spawn from the camera (timed at 16.8M rows), then
    2 warm steps and 3 timed runs of SEG of `run_headless(targets_live=
    True)`, beside phase 10's figure without targets."""
    from tendrils_tpu_torch.ops import cuda_lib
    import tendrils_tpu_torch as tt
    with_merge(eng, False)
    eng.state["target"] = 0.003
    sp = image_spawner("direct")
    sp.speed = 0.3
    sp.set_pixels(camera_grid(0))
    ms = time_spawn("16m-live-show direct target (camera)",
                    lambda: sp.spawn(eng, target="targets"), eng.config.n)
    spawned = targets_by_id(eng.sim).clone()
    eng.sim.force = None
    cuda_lib.reset_counts()

    def run(sim, steps, t_sim):
        return tt.run_headless(sim, eng.params(), eng.config,
                               eng._view_size, t_sim, DT, steps,
                               targets_live=True)

    sim = run(eng.sim, 2, eng.timer.time)
    t_sim = eng.timer.time + 2 * DT
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sim = run(sim, SEG, t_sim)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) / SEG)
        t_sim += SEG * DT
    eng.sim, eng.timer.time = sim, t_sim
    launches = dict(cuda_lib.launches)
    per = dict(CONFIG3_OFF, gather_reconstruct_targets=1)
    del per["gather_reconstruct"]
    per["pack_g3"] = per.pop("pack")
    check_launches("16m-live-show live targets", 2 + 3 * SEG, per, launches,
                   dict(cuda_lib.plain_calls))
    if launches.get("bilinear_gather") != K5:
        fail(f"16m-live-show live targets: launches {launches}")
    check_targets(sim, spawned, "16m-live-show live targets")
    alive, texels = carry_ok(sim, eng.config, "16m-live-show live targets")
    ab, turns = targets_in_turns(eng, sim, SEG, t_sim)
    med = statistics.median(times)
    print(f"[14] 16m-live-show with live targets (gather mode 3, merge off): "
          f"direct target spawn device {ms}; {2 + 3 * SEG} "
          f"run_headless(targets_live=True) steps, launches {launches}, no "
          f"plain calls; the targets by identity the spawned xy bit for "
          f"bit; {alive} alive, {texels} flow texels; {med * 1e3:.3f} "
          f"ms/frame (3 x {SEG}: "
          f"{', '.join(f'{t * 1e3:.3f}' for t in times)}) against "
          f"{headless_ms:.3f} without targets (phase 10); "
          f"{turns_line(ab, turns)}")
    return launches


def run_targets_config4(io_ms):
    """Phase 14 at config 4: the demo's `spawn_image_targets` from the
    camera, then the io frame (K6 with the targets): 2 warm frames and 3
    timed runs of IO_FRAMES, beside phase 6's figure without targets."""
    from tendrils_tpu_torch import models
    from tendrils_tpu_torch.feeds import IoFeed
    from tendrils_tpu_torch.ops import cuda_lib
    eng = models.build("optical-flow-driven")
    feed = IoFeed(eng)
    feed.frame(0)
    eng.state["target"] = 0.003
    spawn_image_targets(eng, image_spawner("direct"), camera_grid(1))
    spawned = targets_by_id(eng.sim).clone()
    cuda_lib.reset_counts()
    feed.frame(1)
    feed.frame(2)
    frame_i = itertools.count(3)
    times = [timed_frames(lambda: feed.frame(next(frame_i)), IO_FRAMES)
             for _ in range(3)]
    sec = statistics.median(times)
    frames = 2 + 3 * IO_FRAMES
    launches = dict(cuda_lib.launches)
    per = dict(PATH_C_RUNNING, reconstruct_resident_targets=1)
    del per["reconstruct_resident"]
    check_launches("optical-flow-driven live targets", frames, per, launches,
                   dict(cuda_lib.plain_calls))
    if launches.get("bilinear_gather") != K5:
        fail(f"optical-flow-driven live targets: launches {launches}")
    check_targets(eng.sim, spawned, "optical-flow-driven live targets")
    alive, texels = check_state(eng.sim, "optical-flow-driven live targets")
    print(f"[14] optical-flow-driven after the demo's spawn_image_targets "
          f"(a direct target spawn, then a plain one, from the camera; its "
          f"480x640 grid the colour map): {frames} io frames, launches "
          f"{launches}, no plain calls; the targets by identity the spawned "
          f"xy bit for bit; {alive} alive, {texels} flow texels; "
          f"{sec * 1e3:.3f} ms/frame (median of 3 x {IO_FRAMES}: "
          f"{', '.join(f'{t * 1e3:.3f}' for t in times)}) against "
          f"{io_ms:.3f} without targets (phase 6)")
    return launches


def run_facade_helpers(eng):
    """Phase 14: `resize` of config 2's engine to 720x1280 and back, a
    frame after each; `step_buffers` on a config-2 engine with two view
    buffers. Returns the launch counts."""
    import tendrils_tpu_torch as tt
    from tendrils_tpu_torch.models.configs import _backends
    from tendrils_tpu_torch.ops import cuda_lib
    from tendrils_tpu_torch.spawners import spawn_ball
    cuda_lib.reset_counts()
    res = eng.config.view_res
    for view_res in ((720, 1280), res):
        eng.resize(view_res)
        if eng.sim.force is not None or eng.sim.flow.any():
            fail(f"resize to {view_res}: a force or flow left")
        eng.frame()
        torch.cuda.synchronize()
        if tuple(eng.sim.view.shape[-2:]) != view_res:
            fail(f"resize to {view_res}: view {tuple(eng.sim.view.shape)}")
        check_state(eng.sim, f"1m-flow resized to {view_res}")
    ring = tt.Tendrils(tt.EngineConfig(root_num=1024, view_res=res,
                                       num_view_buffers=2, **_backends()),
                       device="cuda")
    ring.setup()
    spawn_ball(radius=0.6, speed=0.01).spawn(ring)
    ring.frame()
    before = ring.sim.view.clone()
    ring.step_buffers()
    if not (torch.equal(ring.sim.view[0], before[1])
            and torch.equal(ring.sim.view[1], before[0])):
        fail("step_buffers: the ring did not roll")
    ring.frame()
    check_state(ring.sim, "1m-flow with 2 view buffers")
    if not ring.sim.view[1].any():
        fail("step_buffers: the rolled buffer is empty")
    launches = dict(cuda_lib.launches)
    if any(cuda_lib.plain_calls.values()) \
            or launches.get("bilinear_gather") != 3 * K5:
        fail(f"facade helpers: launches {launches}, plain calls "
             f"{dict(cuda_lib.plain_calls)}")
    print(f"[14] facade helpers: 1m-flow resized to 720x1280 and back, a "
          f"frame after each (live and finite, K5 after each resize); "
          f"step_buffers on 2 view buffers rolled the ring; launches "
          f"{launches}")
    return launches


def demo_wav(path):
    """The track of tests/test_app.py:211-228: 1 s of a 440 Hz sine, 8 kHz,
    int16 mono, written with `wave`."""
    import math
    import wave
    sr = 8000
    t = np.arange(sr) / sr
    pcm = (np.sin(2 * math.pi * 440 * t) * 20000).astype(np.int16)
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(pcm.tobytes())
    return path


def demo_frame(demo, i):
    """One demo frame as a show feeds it: the synthetic camera's frame `i`
    (`feeds.camera_frame`, 480x640 u8), DEMO_POINTERS pointers moving on
    circles (`feeds.add_pointer_points`, as client pixel coords), then
    `render()`."""
    import math
    from tendrils_tpu_torch import feeds
    demo.feed_video_frame(feeds.camera_frame(i))
    h, w = demo.tendrils.config.view_res
    t = demo.timer["app"].time
    for p in range(DEMO_POINTERS):
        a = 0.004 * t + p * math.pi / 2
        r = 0.3 + 0.1 * p
        demo.pointer_move(p, (r * math.cos(a) + 1) / 2 * w,
                          (1 - r * math.sin(a)) / 2 * h)
    demo.render()


def check_demo(demo, label, emptied=False):
    """The demo's state finite with live particles (none may be left when
    `emptied`: the track timeline's `reset` made every particle inert), its
    screen [4, H, W] and finite; returns the live count."""
    sim = demo.tendrils.sim
    for name in ("particles", "previous", "targets", "flow", "view",
                 "force"):
        v = getattr(sim, name)
        if v is not None and not torch.isfinite(v).all():
            fail(f"{label}: non-finite {name}")
    alive = (sim.particles[0] > -9e5).sum().item()
    if alive == 0 and not emptied:
        fail(f"{label}: no live particles")
    h, w = demo.tendrils.config.view_res
    screen = demo.screen
    if screen is None or tuple(screen.shape) != (4, h, w) \
            or not torch.isfinite(screen).all():
        fail(f"{label}: the screen is "
             f"{None if screen is None else tuple(screen.shape)} or not "
             "finite")
    return alive


def demo_timed(demo, name, ids, runs=3):
    """`name` applied, 2 warm frames, then `runs` timed runs of IO_FRAMES
    frames (synchronised around each; `ids` numbers the camera frames):
    ms/frame, median and runs."""
    demo.apply_preset(name)
    for _ in range(2):
        demo_frame(demo, next(ids))
    times = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(IO_FRAMES):
            demo_frame(demo, next(ids))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) / IO_FRAMES * 1e3)
    check_demo(demo, f"demo {name} timed")
    return statistics.median(times), times


def png_size(path):
    """(height, width) from a PNG's IHDR chunk."""
    with open(path, "rb") as f:
        head = f.read(24)
    if head[:8] != b"\x89PNG\r\n\x1a\n" or head[12:16] != b"IHDR":
        fail(f"{path}: not a PNG")
    w, h = int.from_bytes(head[16:20], "big"), int.from_bytes(head[20:24],
                                                              "big")
    return h, w


def run_cli(args, label):
    """`python -m tendrils_tpu_torch ARGS` in a process of its own from the
    checkout's root; its JSON line."""
    import os
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=root + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", "tendrils_tpu_torch", *args],
                         cwd=root, env=env, capture_output=True, text=True,
                         timeout=600)
    sec = time.perf_counter() - t0
    if out.returncode != 0:
        fail(f"{label}: exit {out.returncode}: {out.stderr[-2000:]}")
    try:
        line = json.loads(out.stdout.strip().splitlines()[-1])
    except (IndexError, ValueError):
        fail(f"{label}: no JSON line in {out.stdout[-500:]!r}")
    keys = ["frames", "particles", "ms_per_frame", "particle_steps_per_sec",
            "out"]
    if list(line) != keys:
        fail(f"{label}: JSON line {line}")
    return line, sec


def run_demo_cli(tmp):
    """Phase 15 (c): the CLI at its defaults in a subprocess, 30 frames of
    `Flow` with every 10th written, then one frame resumed from its
    checkpoint."""
    import os
    first = os.path.join(tmp, "cli")
    line, sec = run_cli(["--preset", "Flow", "--frames", "30", "--every",
                         "10", "--out", first], "the CLI")
    pngs = sorted(f for f in os.listdir(first) if f.endswith(".png"))
    if pngs != [f"frame_{i:05d}.png" for i in (0, 10, 20)] \
            or any(png_size(os.path.join(first, f)) != DEMO_RES
                   for f in pngs):
        fail(f"the CLI wrote {pngs}")
    ck = os.path.join(first, "final.ckpt.npz")
    if line["particles"] != DEMO_ROOT ** 2 or not os.path.exists(ck):
        fail(f"the CLI: {line}, checkpoint {os.path.exists(ck)}")
    second = os.path.join(tmp, "resumed")
    line2, sec2 = run_cli(["--checkpoint", ck, "--frames", "1", "--out",
                           second], "the CLI resumed from a checkpoint")
    t = [json.loads(str(np.load(os.path.join(d, "final.ckpt.npz"))[
        "__meta__"]))["timer"]["time"] for d in (first, second)]
    if abs(t[1] - (t[0] + DT)) > 1e-6:
        fail(f"the resumed CLI ended at time {t[1]}, want {t[0] + DT}")
    print(f"[15] (c) python -m tendrils_tpu_torch --preset Flow --frames 30 "
          f"--every 10: exit 0 in {sec:.1f} s, {pngs} of "
          f"{DEMO_RES[0]}x{DEMO_RES[1]}, final.ckpt.npz; {json.dumps(line)}; "
          f"--checkpoint final.ckpt.npz --frames 1: exit 0 in {sec2:.1f} s, "
          f"its timer one step on ({t[0]:.3f} -> {t[1]:.3f} ms); "
          f"{json.dumps(line2)}")


def run_demo_resume(tmp):
    """Phase 15 (d): `Flow` 5 frames, a checkpoint, 3 more frames; a fresh
    demo loads the checkpoint and renders the same 3 frames (no camera or
    pointers: their history is not in a checkpoint). Equal bit for bit, or
    else, since the checkpoint drops the carried force (the resumed
    engine gathers its first force with K5 at the float positions, the
    original carries K4's from the packed positions), particles and
    previous by identity within the engine frames' atol 1e-4, with the
    two first forces' difference printed."""
    import os
    from tendrils_tpu_torch import engine as tengine
    from tendrils_tpu_torch.app import TendrilsDemo
    from tendrils_tpu_torch.io import load_checkpoint, save_checkpoint
    settings = {"preset": "Flow"}
    demo = TendrilsDemo(settings, **DEMO_CLI)
    for _ in range(5):
        demo.render()
    path = save_checkpoint(os.path.join(tmp, "resume.ckpt.npz"),
                           demo.tendrils)
    carried = demo.tendrils.sim.force.clone()
    order0 = torch.argsort(demo.tendrils.sim.idx)
    for _ in range(3):
        demo.render()
    fresh = TendrilsDemo(settings, **DEMO_CLI)
    load_checkpoint(path, fresh.tendrils)
    eng = fresh.tendrils
    regathered = tengine.initial_force(
        eng.sim, eng.params(), eng.config, eng._view_size,
        tengine.device_f32(eng.timer.time + DT, eng.device))
    order1 = torch.argsort(eng.sim.idx)
    d_force = (carried[:, order0] - regathered[:, order1]).abs().max().item()
    for _ in range(3):
        fresh.render()
    torch.cuda.synchronize()
    a, b = demo.tendrils.sim, fresh.tendrils.sim
    equal = all(torch.equal(getattr(a, f.name), getattr(b, f.name))
                for f in dataclasses.fields(a)
                if getattr(a, f.name) is not None)
    errs = {}
    for name in ("particles", "previous"):
        x = getattr(a, name)[:, torch.argsort(a.idx)]
        y = getattr(b, name)[:, torch.argsort(b.idx)]
        errs[name] = (x - y).abs().max().item()
    if not equal and max(errs.values()) > 1e-4:
        fail(f"checkpoint resume: the resumed run differs by {errs}")
    check_demo(fresh, "demo resumed from a checkpoint")
    print(f"[15] (d) Flow, 5 frames, checkpoint, 3 frames, against a fresh "
          f"demo resumed from the checkpoint for the same 3 frames: "
          + ("every tensor equal bit for bit" if equal else
             "not bit-equal; by identity particles max |d| "
             f"{errs['particles']:.3e}, previous {errs['previous']:.3e} "
             "(held at atol 1e-4)")
          + f"; the first force re-gathered by K5 against the carried K4 "
          f"force: max |d| {d_force:.3e}")


def run_demo(io_ms):
    """Phase 15: the demo application (`TendrilsDemo`) on the card at the
    CLI's defaults: (a) every preset, (b) timed, (c) the CLI, (d) a
    checkpoint resume. Returns the launch counts of (a) and (b)."""
    import tempfile
    from tendrils_tpu_torch.app import PRESETS, TendrilsDemo
    from tendrils_tpu_torch.ops import cuda_lib, draw_cuda, splat_cuda
    with tempfile.TemporaryDirectory() as tmp:
        demo = TendrilsDemo({"track": demo_wav(f"{tmp}/track.wav"),
                             "animate": "true"}, **DEMO_CLI)
        demo.play_track()
        # The track's start sequence (`app/demo.py:_setup_track_start`)
        # calls `reset()` at 60 ms of track time, which respawns every
        # particle inert until its `restart()` at 200 ms; every preset's
        # restart rewinds the clock, so a preset's frames may end between
        # the two. Counted here, by frame.
        resets = []
        reset = demo.reset
        demo.reset = lambda: (resets.append(demo.frame_count), reset())
        frames = itertools.count()
        cuda_lib.reset_counts()
        t0 = time.perf_counter()
        alive = {}
        for name in PRESETS:
            demo.apply_preset(name)
            first = demo.frame_count
            for _ in range(DEMO_FRAMES):
                demo_frame(demo, next(frames))
            alive[name] = check_demo(demo, f"demo {name}", emptied=bool(
                resets) and resets[-1] >= first)
        torch.cuda.synchronize()
        sec_a = time.perf_counter() - t0
        launches_a = dict(cuda_lib.launches)
        n_frames = len(PRESETS) * DEMO_FRAMES
        print(f"[15] (a) the demo at {DEMO_RES[0]}x{DEMO_RES[1]}, "
              f"{demo.tendrils.config.n} particles, a WAV track playing "
              f"with animate=true, a 480x640 camera and {DEMO_POINTERS} "
              f"pointers every frame: each of the {len(PRESETS)} presets "
              f"applied and {DEMO_FRAMES} frames rendered ({n_frames} "
              f"frames, {sec_a:.1f} s with the presets' setups); states "
              f"finite, screens [4, {DEMO_RES[0]}, {DEMO_RES[1]}] finite, "
              f"live particles after each but where the timeline's reset "
              f"had just emptied the sim ({sorted(k for k, v in alive.items() if v == 0)}; "
              f"fewest others {min(v for v in alive.values() if v)}); the "
              f"timeline's reset fired {len(resets)} times; launches "
              f"{launches_a}; "
              "a frame: " + ", ".join(
                  f"{k} {v / n_frames:.2f}" for k, v in launches_a.items()))

        # (b) timed, the track paused (no track reactions mid-run), at
        # quality 0 and at quality 2; the kernels' kept scratch (K5's
        # interleaved copy, K9's int64 planes) is keyed by the grid's
        # shape, so it survives the tiers' re-setups.
        demo.pause_track()
        kept = sorted(map(str, splat_cuda._kept))
        rows = []
        for level in (0, 2):
            demo.quality_change(level)
            n = demo.tendrils.config.n
            mode = draw_cuda.gather_mode(
                n, draw_cuda.seg_tile_count(DEMO_RES), ids=True,
                resident=True)
            for name in DEMO_TIMED:
                ms, times = demo_timed(demo, name, frames)
                rows.append(f"{name} at quality {level} ({n} particles, "
                            f"gather mode {mode}): {ms:.3f} ms/frame ("
                            + ", ".join(f"{t:.3f}" for t in times) + ")")
        demo.quality_change(0)
        demo_frame(demo, next(frames))
        check_demo(demo, "demo back at quality 0")
        torch.cuda.synchronize()
        launches = dict(cuda_lib.launches)
        plain = dict(cuda_lib.plain_calls)
        missing = [k for k in DEMO_PATH if launches.get(k, 0) == 0]
        if missing or any(plain.values()):
            fail(f"demo: no launch of {missing}; launches {launches}, "
                 f"plain calls {plain}")
        print(f"[15] (b) demo render(), median of 3 x {IO_FRAMES} frames "
              f"with the camera and pointers: " + "; ".join(rows)
              + f"; beside phase 6's config-4 io frame {io_ms:.3f} "
              f"ms/frame; K9's kept scratch {kept} before the tiers, "
              f"{sorted(map(str, splat_cuda._kept))} after; launches over "
              f"(a) and (b) {launches}, no plain calls")
        run_demo_cli(tmp)
        run_demo_resume(tmp)
    return launches


# --- phase 16: the generic draw ---------------------------------------------

# Config 2 as `models.build("1m-flow")` builds it; the generic draw runs
# it with `fused_draw=False`, on the "xla" backends, with a flow grid of
# its own or (on the fused draw, with no carried force) a flow pyramid.
GENERIC = dict(root_num=1024, view_res=(1080, 1920), flow_samples=2,
               flow_rows=1, view_samples=2)
# Launches a frame: the generic frame on the "kernel" backends (K5 once a
# step, K9 for each pass), the io frame (K9 for the pointers too), and
# the fused frame with two flow levels (K5 on each, no carried force: the
# exact p0 and rgba8 streams, K3); K13 once a step on every backend
# ("xla" included: the step has no other form on the card).
XLA_FRAME = {"logic_step": 1}
GENERIC_FRAME = {"bilinear_gather": K5, "splat_points": 2 * K9, **XLA_FRAME}
GENERIC_IO = {"bilinear_gather": K5, "splat_points": 3 * K9, **XLA_FRAME}
LEVELS2_FRAME = {"bilinear_gather": 2 * K5, "pack_p0_rgba": 1,
                 "splat_p0_rgba": K2, "resolve": 1, **XLA_FRAME}
VARIANT_FRAMES = 20  # frames of a timed run in phase 16 (d) and (e)
# The generic draw's grids on K9 against the f32 scatter: the tolerance the
# JAX package holds its Pallas splat to (tests/test_splat_pallas.py:29-34).
XLA_TOL = 1e-4
# Phase 16 (c) sanity bounds at config 2 (`fused_against_generic`): the
# most of a grid's touched texels that may read beyond the JAX test's
# tolerance, and the most the flow masses may differ by; only a broken
# draw reaches them.
COVERAGE_HOPS = 0.05
MASS_GAP = 1e-2
# The JAX package's default EngineConfig() (`tendrils_tpu/engine.py:40-60`):
# 512^2 particles at 720x1280, 4 samples x 3 rows a flow segment, 4 x 1 a
# view segment.
JAX_DEFAULT = dict(root_num=512, view_res=(720, 1280), flow_samples=4,
                   flow_rows=3, view_samples=4, view_rows=1)


def generic_engine(backend="kernel", **cfg_kw):
    """An engine at `GENERIC` (fields replaced by `cfg_kw`) with `backend`
    for the splat and the gather, the generic draw (`fused_draw=False`)
    unless `cfg_kw` says otherwise, after the ball spawn of
    `models.build("1m-flow")`."""
    import tendrils_tpu_torch as tt
    from tendrils_tpu_torch.models.configs import _spawned
    kw = dict(GENERIC, splat_backend=backend, gather_backend=backend,
              fused_draw=False)
    kw.update(cfg_kw)
    return _spawned(tt.EngineConfig(**kw))


def counts(label, want):
    """The launch counters equal `want` (kernel -> launches) with no other
    kernel launched and no plain version run; returns the launches."""
    from tendrils_tpu_torch.ops import cuda_lib
    torch.cuda.synchronize()
    launches = {k: v for k, v in cuda_lib.launches.items() if v}
    plain = {k: v for k, v in cuda_lib.plain_calls.items() if v}
    want = {k: v for k, v in want.items() if v}
    if launches != want or plain:
        fail(f"{label}: launches {launches}, want {want}; plain calls "
             f"{plain}")
    return launches


def scaled(per_frame, frames):
    return {k: v * frames for k, v in per_frame.items()}


def add_counts(total, launches):
    for k, v in launches.items():
        total[k] = total.get(k, 0) + v


def headless_runs(eng, steps, runs=3):
    """`runs` timed `run_headless` runs of `steps` steps from the engine's
    state, which keeps the last: (the median s a frame, each run's ms a
    frame)."""
    import tendrils_tpu_torch as tt
    sim, t_sim, times = eng.sim, eng.timer.time, []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sim = tt.run_headless(sim, eng.params(), eng.config, eng._view_size,
                              t_sim, DT, steps, targets_live=False)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        t_sim += steps * DT
    eng.sim, eng.timer.time = sim, t_sim
    return statistics.median(times) / steps, [t / steps * 1e3
                                               for t in times]


def warm_and_time(eng, label, per_frame, steps):
    """Two facade frames and `run_headless` 3 x `steps`, the counters held
    to `per_frame` and the state checked: (launches, s a frame, runs)."""
    from tendrils_tpu_torch.ops import cuda_lib
    cuda_lib.reset_counts()
    eng.frame()
    eng.frame()
    sec, runs = headless_runs(eng, steps)
    launches = counts(label, scaled(per_frame, 2 + 3 * steps))
    if eng.sim.force is not None:
        fail(f"{label}: a carried force")
    check_state(eng.sim, label)
    return launches, sec, runs


def calls_of(owner, name, run):
    """`run()`, recording every call of `owner.name`: [(args, kwargs)],
    tensors cloned."""
    got = []
    fn = getattr(owner, name)

    def rec(*a, **kw):
        got.append(([x.clone() if isinstance(x, torch.Tensor) else x
                     for x in a], dict(kw)))
        return fn(*a, **kw)

    setattr(owner, name, rec)
    try:
        run()
    finally:
        setattr(owner, name, fn)
    torch.cuda.synchronize()
    return got


def check_generic_k9(eng, out):
    """K9 on the two passes of a real generic config-2 frame (2,097,152
    samples each): equal to its plain version, the same bits on two
    calls; the flow pass timed into `out["splat_points_generic"]` (reads
    x, y, alpha and 4 payload values, 28 B a sample; writes the 6-plane
    accumulator once; 12 operations a valid corner)."""
    from tendrils_tpu_torch.ops import splat_cuda
    passes = calls_of(splat_cuda, "splat_accumulate", eng.frame)
    if len(passes) != 2:
        fail(f"generic frame: {len(passes)} K9 calls, want 2")
    rows = []
    for label, (a, _) in zip(("flow", "view"), passes):
        (h, w), x, y, vals, alpha = a
        got = k9_planes(splat_cuda.splat_accumulate(*a))
        equal_to_plain(f"splat_points (generic {label} pass)", got,
                       k9_planes(splat_cuda.splat_accumulate_plain(*a)))
        if not torch.equal(got, k9_planes(splat_cuda.splat_accumulate(*a))):
            fail(f"splat_points (generic {label} pass): two calls differ")
        x0, y0 = torch.floor(x - 0.5), torch.floor(y - 0.5)
        corners = sum(((x0 + dx >= 0) & (x0 + dx < w) & (y0 + dy >= 0)
                       & (y0 + dy < h) & (alpha != 0)).sum().item()
                      for dx in (0, 1) for dy in (0, 1))
        rows.append(f"{label} M = {x.numel()}, {corners} corners in the "
                    f"grid")
        if label == "flow":
            timed_row(out, "splat_points_generic", 0.0,
                      lambda: splat_cuda.splat_accumulate(*a),
                      lambda: splat_cuda.splat_accumulate_plain(*a),
                      x.numel() * 28 + 6 * h * w * 4, 12 * corners,
                      label=f" (generic flow pass, M = {x.numel()})")
        del got
    print("  K9 on a real generic config-2 frame's passes (" + "; ".join(rows)
          + "): each equal to its plain version, the same bits on two calls")


def check_pyramid_k5(eng):
    """K5 on each level of a real two-level step (config 2: 1080x1920 and
    540x960), within rtol 1e-5 of its plain version."""
    from tendrils_tpu_torch import engine as te
    from tendrils_tpu_torch.ops import gather_cuda
    calls = calls_of(te, "bilinear_gather", eng.frame)
    shapes = [tuple(a[0].shape[1:]) for a, _ in calls]
    if shapes != [(1080, 1920), (540, 960)]:
        fail(f"two-level step: K5 on {shapes}")
    for a, _ in calls:
        close(f"bilinear_gather (level {tuple(a[0].shape[1:])})",
              [gather_cuda.bilinear_gather(*a)],
              [gather_cuda.bilinear_gather_plain(*a)])
    return shapes


def agree_backends(eng):
    """(b): one step from (a)'s state (K5), then its draw on K9 and on the
    f32 scatter: flow and view within XLA_TOL. Returns the max |d| of each
    and the largest |value| it is read against."""
    from tendrils_tpu_torch import engine as te
    params = eng.params()
    t = te.device_f32(eng.timer.time + DT, "cuda")
    sim = te.step_sim(eng.sim, params, t, te.device_f32(DT, "cuda"),
                      eng.config,
                      eng._view_size)
    outs = [te.draw_sim(sim, params, t, dataclasses.replace(
        eng.config, splat_backend=b), eng._view_size) for b in ("kernel",
                                                               "xla")]
    errs = {}
    for name in ("flow", "view"):
        a, b = (getattr(o, name) for o in outs)
        if not torch.allclose(b, a, rtol=XLA_TOL, atol=XLA_TOL):
            bad = (b - a).abs() > XLA_TOL + XLA_TOL * a.abs()
            fail(f"(b) {name} on the f32 scatter against K9: "
                 f"{bad.sum().item()} "
                 f"values beyond rtol/atol {XLA_TOL}, max |d| "
                 f"{(b - a).abs().max().item():.3e}")
        errs[name] = ((b - a).abs().max().item(), a.abs().max().item())
    return errs


def fused_against_generic(strict, **size):
    """(c): flowWidth = lineWidth = 1, one step + draw at time 16 ms
    (tests/test_fused_draw.py:33-66's step) from one converted ball spawn
    on the fused kernel draw, the generic K9 draw and the generic f32
    scatter, at `size` (`generic_engine`'s fields), the grids 1-px
    smoothed. `strict` (the JAX test's 16^2 particles at 32x128): every
    grid within rtol 5e-2 / atol 2e-2 and the flow's mass (the grid's
    sum) within 1e-3, as the JAX test holds them. Otherwise (config 2)
    the texels beyond that tolerance are counted, by grid and channel
    group (the flow's stamp, the time times the coverage, in units of the
    time), and held only to sanity bounds (COVERAGE_HOPS of the touched
    texels, MASS_GAP): at config 2 a segment spans ~3-10 px over 2
    samples, so a sample's alpha saturates at 1 - 1e-4 and the bilinear
    log-coverage (1 - a)^w turns a corner weight of 0.05 into a coverage
    of 0.37; the fused draw's 1/pscale-px placement hops such a corner
    onto the next texel or off it (one flow texel at 540x960 read 0.2565
    generic, 0 fused, from one particle), which no 1-px smoothing
    absorbs, and the fused draw loses ~0.15 % of the flow's mass. Both
    draws compute the JAX package's arithmetic
    (tests/test_torch_generic.py), and its own draws differ alike: at
    136x240 with 9.6-px segments the JAX fused and generic flow masses
    differ by 1.17e-3 on the CPU. Returns `(max |d| by comparison, the
    two masses, {comparison: (beyond, touched)})`."""
    from tendrils_tpu_torch import convert, engine as te
    base = generic_engine(**size)
    base.state.update(flowWidth=1.0, lineWidth=1.0)
    state, params = convert.sim_to_numpy(base.sim), base.params()
    t = te.device_f32(16.0, "cuda")
    outs = {}
    for name, backend, fused in (("fused", "kernel", True),
                                 ("generic K9", "kernel", False),
                                 ("generic xla", "xla", False)):
        cfg = dataclasses.replace(base.config, splat_backend=backend,
                                  fused_draw=fused)
        sim = te.step_sim(convert.sim_from_numpy(state, "cuda"), params, t,
                          t, cfg, base._view_size)
        sim = te.draw_sim(sim, params, t, cfg, base._view_size)
        outs[name] = (sim.flow, sim.view[0])

    def smooth(img):
        return torch.nn.functional.avg_pool2d(img[:, None], 3, stride=1,
                                              padding=1)[:, 0]

    worst, hops = {}, {}
    for other in ("generic K9", "generic xla"):
        fa, va = (smooth(g) for g in outs["fused"])
        fb, vb = (smooth(g) for g in outs[other])
        for label, a, b in (("view", va, vb),
                            ("flow velocity", fa[:2], fb[:2]),
                            ("flow stamp", fa[2] / t, fb[2] / t),
                            ("flow weight", fa[3], fb[3])):
            n = ((a - b).abs() > 2e-2 + 5e-2 * b.abs()).sum().item()
            touched = ((a != 0) | (b != 0)).sum().item()
            key = f"{other} {label}"
            worst[key], hops[key] = (a - b).abs().max().item(), (n, touched)
            if n > (0 if strict else COVERAGE_HOPS * touched):
                fail(f"(c) fused against {key}: {n} of {touched} texels "
                     "beyond rtol 5e-2 / atol 2e-2 after smoothing")
    mass = [outs[k][0].double().sum().item() for k in ("fused",
                                                         "generic xla")]
    if abs(mass[0] - mass[1]) > (1e-3 if strict else MASS_GAP) * mass[1]:
        fail(f"(c) flow mass fused {mass[0]} against generic {mass[1]}")
    return worst, mass, hops


def run_generic_variants(card, total):
    """(d) the JAX default config, (e) the flow variants, (f) the io frame
    and the CLI on xla; prints a line each; adds their launches to
    `total`."""
    import tempfile
    import tendrils_tpu_torch as tt
    from tendrils_tpu_torch.feeds import IoFeed
    from tendrils_tpu_torch.models.configs import _spawned
    rows = []
    for backend in ("kernel", "xla"):
        eng = generic_engine(backend, **JAX_DEFAULT)
        launches, sec, runs = warm_and_time(
            eng, f"(d) JAX default on {backend}",
            GENERIC_FRAME if backend == "kernel" else XLA_FRAME,
            VARIANT_FRAMES)
        add_counts(total, launches)
        rows.append(f"{backend} {sec * 1e3:.3f} ms/frame ("
                    + ", ".join(f"{r:.3f}" for r in runs) + ")")
    print(f"[16] (d) the JAX package's default EngineConfig() ({eng.config.n}"
          f" particles, {JAX_DEFAULT['view_res'][0]}x"
          f"{JAX_DEFAULT['view_res'][1]}, flow 4 x 3 samples, view 4 x 1) "
          f"on the generic draw, 2 warm frames and median of 3 x "
          f"{VARIANT_FRAMES} headless steps: " + "; ".join(rows)
          + f"; K5 once a step and K9 twice a frame on kernel, K13 alone "
          f"on xla, no plain call ({card})")
    del eng

    eng = generic_engine(fused_draw=True, flow_levels=2)
    shapes = check_pyramid_k5(eng)
    launches, sec, runs = warm_and_time(eng, "(e) flow_levels=2",
                                        LEVELS2_FRAME, VARIANT_FRAMES)
    add_counts(total, launches)
    line = (f"flow_levels=2 (the fused draw without a carried force, K5 on "
            f"{shapes} each step, within rtol 1e-5 of its plain version): "
            f"{sec * 1e3:.3f} ms/frame ("
            + ", ".join(f"{r:.3f}" for r in runs) + f"), launches {launches}")
    del eng
    eng = generic_engine(fused_draw=True, flow_res=(540, 960))
    launches, sec, runs = warm_and_time(eng, "(e) flow_res=(540, 960)",
                                        GENERIC_FRAME, VARIANT_FRAMES)
    add_counts(total, launches)
    if tuple(eng.sim.flow.shape) != (4, 540, 960):
        fail(f"(e) flow grid {tuple(eng.sim.flow.shape)}")
    print(f"[16] (e) config 2 with the flow variants, 2 warm frames and "
          f"median of 3 x {VARIANT_FRAMES}: {line}; flow_res=(540, 960) "
          f"under 1080x1920 (the generic draw with fused_draw=True, K9 on "
          f"two grids): {sec * 1e3:.3f} ms/frame ("
          + ", ".join(f"{r:.3f}" for r in runs) + f"), launches {launches}; "
          f"no plain call ({card})")
    del eng

    rows = []
    for backend in ("kernel", "xla"):
        cfg = tt.EngineConfig(root_num=512, view_res=(720, 1280),
                              flow_samples=2, flow_rows=1, view_samples=2,
                              splat_backend=backend, gather_backend=backend,
                              fused_draw=False)
        eng = _spawned(cfg)
        feed = IoFeed(eng)
        from tendrils_tpu_torch.ops import cuda_lib
        cuda_lib.reset_counts()
        feed.frame(0)
        feed.frame(1)
        frames = itertools.count(2)
        times = [timed_frames(lambda: feed.frame(next(frames)), IO_FRAMES)
                 for _ in range(3)]
        launches = counts(f"(f) io frame on {backend}", scaled(
            GENERIC_IO if backend == "kernel" else XLA_FRAME,
            2 + 3 * IO_FRAMES))
        add_counts(total, launches)
        alive, texels = check_state(eng.sim, f"(f) io frame on {backend}")
        rows.append(f"{backend} {statistics.median(times) * 1e3:.3f} "
                    f"ms/frame (" + ", ".join(f"{t * 1e3:.3f}" for t in times)
                    + f"), {alive} alive, {texels} flow texels, launches "
                    f"{launches}")
        del eng, feed
    with tempfile.TemporaryDirectory() as tmp:
        line, sec = run_cli(["--backend", "xla", "--preset", "Flow",
                             "--frames", "10", "--out", tmp],
                            "the CLI on xla")
    if line["frames"] != 10 or line["particles"] != DEMO_ROOT ** 2:
        fail(f"the CLI on xla: {line}")
    print(f"[16] (f) the config-4 io frame (the camera, 4 pointers) on the "
          f"generic draw, 2 warm and median of 3 x {IO_FRAMES}: "
          + "; ".join(rows) + f"; no plain call ({card}). python -m "
          f"tendrils_tpu_torch --backend xla --preset Flow --frames 10: "
          f"exit 0 in {sec:.1f} s, {json.dumps(line)}")


def run_host_modules(eng, card):
    """(g): `geom` on its native path (and within 1e-5 of its numpy twin),
    `utils.profiling.FrameProfiler` around 5 generic config-2 frames and
    `trace` around one."""
    import tempfile
    from tendrils_tpu_torch import geom
    from tendrils_tpu_torch.utils import profiling
    geom.paths.clear()
    path = np.random.default_rng(0).uniform(-1, 1, (256, 2))
    got = geom.polyline_normals(path)
    paths = dict(geom.paths)
    if paths != {"native": 1}:
        fail(f"geom took {paths}, not its native path")
    saved, geom._native = geom._native, False
    try:
        want = geom.polyline_normals(path)
    finally:
        geom._native = saved
    err = max(np.abs(a - b).max() for a, b in zip(got, want))
    if err > 1e-5:
        fail(f"geom native against numpy: {err:.3e}")
    prof = profiling.FrameProfiler()
    for _ in range(5):
        prof.begin_frame()
        eng.timer.tick()
        with prof.section("step") as box:
            eng.step()
            box["result"] = eng.sim.particles
        with prof.section("draw") as box:
            eng.draw()
            box["result"] = eng.sim.view
        prof.end_frame()
    summary = prof.summary()
    with tempfile.TemporaryDirectory() as tmp:
        with profiling.trace(tmp):
            eng.frame()
            profiling.sync(eng.sim)
        events = json.loads(open(f"{tmp}/trace.json").read())
    events = events.get("traceEvents", events) if isinstance(
        events, dict) else events
    k9 = sum(1 for e in events if "splat_points" in str(e.get("name", "")))
    check_state(eng.sim, "(g) generic frames under the profiler")
    print(f"[16] (g) geom.polyline_normals on its native path "
          f"(native/line_mesh.cpp built with g++; paths {paths}; within "
          f"{err:.1e} of the numpy twin); FrameProfiler around 5 generic "
          f"config-2 frames: " + ", ".join(
              f"{k} mean {v['mean'] * 1e3:.3f} ms" for k, v in summary.items())
          + f" ({card}); utils.profiling.trace around one frame wrote "
          f"trace.json with {len(events)} events, {k9} of K9's kernels")


def run_generic(card, fused_ms):
    """Phase 16: the generic draw. (a) config 2 on the generic kernel draw,
    (b) on the "xla" backends, (c) fused against generic, (d) the JAX
    default config, (e) the flow variants, (f) the io frame and the CLI,
    (g) the host modules. Returns (the launch counts, the K9 row)."""
    from tendrils_tpu_torch.ops import cuda_lib
    total, out = {}, {}
    eng = generic_engine()
    cuda_lib.reset_counts()
    eng.frame()
    eng.frame()
    sec, runs = headless_runs(eng, STEPS)
    launches = counts("(a) generic kernel draw",
                      scaled(GENERIC_FRAME, 2 + 3 * STEPS))
    add_counts(total, launches)
    alive, texels = check_state(eng.sim, "(a) generic kernel draw")
    if eng.sim.force is not None:
        fail("(a) generic kernel draw: a carried force")
    names = replay(eng, eng.frame, "generic 1m-flow",
                   need=("particles", "flow", "view"))
    err = agree_with_plain(fused_draw=False)
    print(f"[16] (a) 1m-flow on the generic draw (fused_draw=False, kernel "
          f"backends): 2 frames + 3 x {STEPS} headless steps, launches "
          f"{launches} (K5 once a step, K9 twice a frame), no plain calls; "
          f"{alive} alive, {texels} flow texels; {sec * 1e3:.3f} ms/frame, "
          f"{eng.config.n / sec:.0f} particle-steps/s (median of 3 x {STEPS}"
          f": " + ", ".join(f"{r:.3f}" for r in runs) + " ms/frame) beside "
          f"{fused_ms:.3f} on the fused draw (phase 4) ({card}); a frame "
          f"replayed: {', '.join(names)} equal bit for bit; card vs CPU "
          f"particles max |d| {err:.2e}")
    check_generic_k9(eng, out)
    cuda_lib.reset_counts()

    xla = generic_engine("xla")
    _, sec_x, runs_x = warm_and_time(xla, "(b) generic xla draw",
                                     XLA_FRAME, STEPS)
    del xla
    errs = agree_backends(eng)
    print(f"[16] (b) 1m-flow on the \"xla\" backends (the JAX package's "
          f"default off a TPU): 2 frames + 3 x {STEPS} headless steps, K13 "
          f"the one kernel launched, no plain call; {sec_x * 1e3:.3f} "
          f"ms/frame, "
          f"{eng.config.n / sec_x:.0f} particle-steps/s ("
          + ", ".join(f"{r:.3f}" for r in runs_x) + f" ms/frame) ({card}); "
          f"one draw from (a)'s state on the f32 scatter against K9, within "
          f"rtol/atol {XLA_TOL}: " + ", ".join(
              f"{k} max |d| {d:.3e} (max |value| {m:.3g})"
              for k, (d, m) in errs.items()))
    worst, mass, _ = fused_against_generic(
        True, root_num=16, view_res=(32, 128))
    print(f"[16] (c) tests/test_fused_draw.py:33-66 on the card (16^2 "
          f"particles, 32x128, flowWidth = lineWidth = 1, one step + draw "
          f"at 16 ms from one ball spawn): the fused kernel draw against "
          f"the generic K9 and xla draws, 1-px smoothed, within rtol 5e-2 "
          f"/ atol 2e-2 (max |d| " + ", ".join(
              f"{k} {v:.3e}" for k, v in worst.items())
          + f"), flow mass {mass[0]:.6g} against {mass[1]:.6g} "
          f"({mass[0] / mass[1] - 1:+.3e}, within 1e-3)")
    _, mass, hops = fused_against_generic(False)
    print(f"[16] (c) the same at config 2 (1,048,576 particles, 1080x1920, "
          f"segments of ~3-10 px over 2 samples: saturated alphas), the "
          f"texels beyond that tolerance, of those touched: " + ", ".join(
              f"{k} {n} of {m} ({n / max(m, 1):.2%})"
              for k, (n, m) in hops.items())
          + f"; flow mass {mass[0]:.6g} against {mass[1]:.6g} "
          f"({mass[0] / mass[1] - 1:+.3e}); sanity bounds "
          f"{COVERAGE_HOPS:.0%} and {MASS_GAP:g}")
    cuda_lib.reset_counts()
    run_generic_variants(card, total)
    cuda_lib.reset_counts()
    run_host_modules(eng, card)
    add_counts(total, dict(cuda_lib.launches))
    return total, out


# --- phase 17: multi-device -------------------------------------------------
# The sharded frames (`tendrils_tpu_torch.parallel`) on one card: (a) NCCL at
# world size 1 in this process, (b) 2 and (c) 4 gloo ranks in processes of
# their own sharing the card (NCCL refuses two ranks on one GPU).

MULTI_FRAMES = 10  # (a) data-parallel frames at config 2
SLAB_FRAMES = 3  # (a) slab frames at config 2
RANK_FRAMES = 2  # (b), (c) sharded frames a check
MERGE_FRAMES = 3  # (b) the merge reorder at config 3
RANK_TIMEOUT = 300.0  # s a spawn of ranks may take
# tests/test_parallel.py's slab tolerances (:134-141): particles rtol,
# atol; grids rtol, atol.
SLAB_TOL = ((1e-4, 5e-5), (1e-4, 1e-5))
# (b) config 2, a shard in gather mode 3 against one device in mode 1: mode
# 3 clears the positions' low mantissa bits (x: 2, y: 3) before they are
# quantised, so a sample near a sub-pixel edge may deposit one step over,
# and a texel it reaches or leaves takes another stamp. Particles by
# identity within MODE3_ATOL, each grid's total within MODE3_MASS; the
# share of texels beyond tests/test_parallel.py:76-81's tolerance and the
# force's max |d| are printed. Against one device forced into mode 3
# (`Mode3`) every tensor must be equal bit for bit.
MODE3_ATOL = 1e-4
MODE3_MASS = 1e-4


def clone_sim(sim):
    return dataclasses.replace(sim, **{
        f.name: getattr(sim, f.name).clone()
        for f in dataclasses.fields(sim)
        if isinstance(getattr(sim, f.name), torch.Tensor)})


def twin(name, **cfg_kw):
    """Two engines of `models.build(name)` holding one state (the second a
    copy of the first's), `cfg_kw` replaced in both configs."""
    from tendrils_tpu_torch import models
    a = models.build(name)
    b = models.build(name)
    for e in (a, b):
        e.config = dataclasses.replace(e.config, **cfg_kw)
        e.reseed_derived()
    b.sim, b.timer.time = clone_sim(a.sim), a.timer.time
    return a, b


def timed(frame, frames):
    """`frames` calls of `frame()`, each synchronised; the ms of each."""
    ms = []
    for _ in range(frames):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        frame()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return ms


def xla_tail_frame(eng):
    """One frame of the single device as the facade runs it, with the XLA
    resolve tail (`fast_resolve=False`): the slab frame's resolve
    (`_widen_excess`, `composite_over`)."""
    from tendrils_tpu_torch import engine
    eng.timer.tick()
    x = eng._frame_inputs()
    eng.sim = engine._frame(
        eng.sim, x.params, x.time, x.dt, eng.config, eng._view_size,
        targets_live=x.targets_live, fast_resolve=False,
        host_widths=x.host_widths)


class Mode3:
    """The single device's resident draw in the shards' gather mode 3
    (ids bounded by twice its rows), so that it clears the same position
    bits as a shard whose ids reach past its rows."""

    def __enter__(self):
        from tendrils_tpu_torch.ops import draw_cuda
        self.orig = orig = draw_cuda.gather_mode

        def mode3(n, num_tiles, *, ids, resident, idx_bound=None):
            return orig(n, num_tiles, ids=ids, resident=resident,
                        idx_bound=None if idx_bound is None else 2 * n)
        draw_cuda.gather_mode = mode3
        return self

    def __exit__(self, *exc):
        from tendrils_tpu_torch.ops import draw_cuda
        draw_cuda.gather_mode = self.orig


def rows_by_id(single, shard, name):
    """`single`'s rows of field `name` with the ids of `shard`'s rows."""
    inv = torch.empty_like(single.idx, dtype=torch.int64)
    inv[single.idx.long()] = torch.arange(single.idx.numel(),
                                          device=single.idx.device)
    return getattr(single, name)[..., inv[shard.idx.long()]]


def max_d(a, b):
    return (a.double() - b.double()).abs().max().item()


def beyond(got, want, rtol, atol):
    """The share of values of `got` beyond rtol / atol of `want`."""
    return ((got - want).abs() > atol + rtol * want.abs()).float().mean(
        ).item()


def slab_rows(grid, rank, ranks, axis):
    h = grid.shape[axis] // ranks
    return grid.narrow(axis, rank * h, h)


def within_slab_tol(label, shard, single, rank=0, ranks=1):
    """A slab frame's state (this rank's rows in the single device's order,
    its slab of the grids) against the single device's, within SLAB_TOL;
    returns the max |d| of each."""
    (prt, pat), (grt, gat) = SLAB_TOL
    n = single.particles.shape[1] // ranks
    out = {}
    pairs = [(k, getattr(shard, k), getattr(single, k)[:, rank * n:
                                                       (rank + 1) * n])
             for k in ("particles", "previous", "force")]
    pairs += [("flow", shard.flow, slab_rows(single.flow, rank, ranks, 1)),
              ("view", shard.view, slab_rows(single.view, rank, ranks, 2))]
    for k, got, want in pairs:
        rtol, atol = (prt, pat) if k in ("particles", "previous") \
            else (grt, gat)
        if not torch.allclose(got, want, rtol=rtol, atol=atol):
            fail(f"{label}: {k} beyond rtol {rtol} / atol {atol} of the "
                 f"single device (max |d| {max_d(got, want):.3e})")
        out[k] = max_d(got, want)
    return out


def sum_counts(counts):
    total = collections.Counter()
    for c in counts:
        total.update(c)
    return dict(total)


def run_nccl_world1(card):
    """Phase 17 (a): NCCL at world size 1 in this process (a `file://`
    store): `ParallelTendrils` at config 2 for MULTI_FRAMES frames against
    the single-device `Tendrils` from one state, every tensor equal bit
    for bit (both in gather mode 1); `SpatialTendrils` for SLAB_FRAMES
    frames against the single device's classic frame with the XLA tail
    (the slab frame's gather order and resolve), within SLAB_TOL. Returns
    (the sharded runs' launches, the comm payload a frame by layout)."""
    import tempfile

    import torch.distributed as dist
    from tendrils_tpu_torch.ops import cuda_lib
    from tendrils_tpu_torch.parallel import (ParallelTendrils,
                                             SpatialTendrils, comm,
                                             make_mesh)
    launches, payload = [], {}
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/store",
                                rank=0, world_size=1)
        try:
            if dist.get_backend() != "nccl":
                fail(f"(a) backend {dist.get_backend()}, want nccl")
            mesh = make_mesh()
            ref, eng = twin("1m-flow")
            par = ParallelTendrils(eng, mesh)
            cuda_lib.reset_counts()
            comm.reset_counts()
            par_ms = timed(par.frame, MULTI_FRAMES)
            launches.append(dict(cuda_lib.launches))
            if cuda_lib.plain_calls:
                fail(f"(a) plain calls {dict(cuda_lib.plain_calls)}")
            payload["dp"] = {k: v / MULTI_FRAMES
                             for k, v in comm.payload.items()}
            calls = dict(comm.calls)
            ref_ms = timed(ref.frame, MULTI_FRAMES)
            names = same_state(ref.sim, eng.sim, "17 (a) data-parallel")
            check_state(eng.sim, "17 (a) data-parallel")
            del ref, eng, par

            ref, eng = twin("1m-flow", resident_stream=False)
            spar = SpatialTendrils(eng, mesh)
            cuda_lib.reset_counts()
            comm.reset_counts()
            slab_ms = timed(spar.frame, SLAB_FRAMES)
            launches.append(dict(cuda_lib.launches))
            payload["slab"] = {k: v / SLAB_FRAMES
                               for k, v in comm.payload.items()}
            slab_calls = dict(comm.calls)
            tail_ms = timed(lambda: xla_tail_frame(ref), SLAB_FRAMES)
            errs = within_slab_tol("17 (a) slab", eng.sim, ref.sim)
            exact = [k for k in ("particles", "flow", "view", "force")
                     if torch.equal(getattr(eng.sim, k), getattr(ref.sim, k))]
            del ref, eng, spar
        finally:
            dist.destroy_process_group()
    med = statistics.median
    print(f"[17] (a) NCCL, world size 1: ParallelTendrils at config 2 "
          f"(1m-flow, 1,048,576 particles, 1080x1920), {MULTI_FRAMES} "
          f"frames against Tendrils from one state: {', '.join(names)} "
          f"equal bit for bit (gather mode 1 on both); "
          f"{med(par_ms[1:]):.3f} ms/frame against {med(ref_ms[1:]):.3f} "
          f"single-device (medians of frames 2-{MULTI_FRAMES}; first "
          f"frames {par_ms[0]:.3f} and {ref_ms[0]:.3f}); collectives "
          f"{calls} over the run, {payload['dp']} bytes a frame "
          f"handed over ({card})")
    print(f"[17] (a) SpatialTendrils at config 2, {SLAB_FRAMES} frames "
          f"against the single device's classic frame with the XLA tail: "
          f"within rtol/atol {SLAB_TOL} (max |d| " + ", ".join(
              f"{k} {v:.3e}" for k, v in errs.items())
          + f"; bit-equal: {', '.join(exact) or 'none'}); "
          f"{med(slab_ms):.3f} ms/frame against {med(tail_ms):.3f} "
          f"(medians of {SLAB_FRAMES}: " + ", ".join(
              f"{a:.3f}/{b:.3f}" for a, b in zip(slab_ms, tail_ms))
          + f"); collectives {slab_calls}, {payload['slab']} bytes a "
          f"frame handed over ({card})")
    return sum_counts(launches), payload


def identity_diffs(ref, eng):
    """`{field: (equal, max |d|)}` of a shard against the single device:
    rows by identity, grids whole."""
    diffs = {}
    for k in ("particles", "previous", "targets", "force"):
        want = rows_by_id(ref.sim, eng.sim, k)
        diffs[k] = (torch.equal(getattr(eng.sim, k), want),
                    max_d(getattr(eng.sim, k), want))
    for k in ("flow", "view"):
        diffs[k] = (torch.equal(getattr(eng.sim, k), getattr(ref.sim, k)),
                    max_d(getattr(eng.sim, k), getattr(ref.sim, k)))
    return diffs


def rank_dp_identity(name, frames, mode3=False):
    """The data-parallel frame on this rank's shard against the single
    device's frames it runs itself (with `mode3`, also against a single
    device forced into the shards' gather mode, `Mode3`): `{field: (equal,
    max |d|)}`, rows by identity, and each grid's share of texels beyond
    rtol 1e-4 / atol 1e-5 and relative total difference. Returns
    (launches of the sharded run, ms a frame of the sharded and the single
    run, comm moved a frame, diffs, grids, diffs against mode 3)."""
    from tendrils_tpu_torch.ops import cuda_lib
    from tendrils_tpu_torch.parallel import ParallelTendrils, comm, make_mesh
    ref, eng = twin(name)
    ref3 = twin(name)[1] if mode3 else None
    par = ParallelTendrils(eng, make_mesh())
    cuda_lib.reset_counts()
    comm.reset_counts()
    ms = timed(par.frame, frames)
    launches = dict(cuda_lib.launches)
    moved = {k: v / frames for k, v in comm.moved.items()}
    ref_ms = timed(ref.frame, frames)
    diffs3 = None
    if mode3:
        with Mode3():
            for _ in range(frames):
                ref3.frame()
        diffs3 = identity_diffs(ref3, eng)
    diffs = identity_diffs(ref, eng)
    grids = {}
    for k in ("flow", "view"):
        got, want = getattr(eng.sim, k), getattr(ref.sim, k)
        grids[k] = (beyond(got, want, 1e-4, 1e-5),
                    abs(got.double().sum().item() / want.double().sum().item()
                        - 1.0))
    return launches, (ms, ref_ms), moved, diffs, grids, diffs3


def rank_slab(name, frames, rank, ranks):
    from tendrils_tpu_torch.ops import cuda_lib
    from tendrils_tpu_torch.parallel import SpatialTendrils, comm, make_mesh
    ref, eng = twin(name, resident_stream=False)
    spar = SpatialTendrils(eng, make_mesh())
    cuda_lib.reset_counts()
    comm.reset_counts()
    ms = timed(spar.frame, frames)
    launches = dict(cuda_lib.launches)
    moved = {k: v / frames for k, v in comm.moved.items()}
    for _ in range(frames):
        xla_tail_frame(ref)
    errs = within_slab_tol(f"17 slab, rank {rank} of {ranks}", eng.sim,
                           ref.sim, rank, ranks)
    return launches, ms, moved, errs


def rank_merge(frames):
    from tendrils_tpu_torch.ops import cuda_lib
    from tendrils_tpu_torch.parallel import ParallelTendrils, make_mesh
    eng = twin("4m-respawn-stress", merge_reorder=True)[1]
    par = ParallelTendrils(eng, make_mesh())
    cuda_lib.reset_counts()
    ms = timed(par.frame, frames)
    launches, events = dict(cuda_lib.launches), dict(cuda_lib.events)
    check_state(eng.sim, "17 (b) merge")
    return launches, ms, events, eng.sim.sort_key.numel()


def gloo_ranks_2(rank, ranks):
    """Phase 17 (b), on each of 2 gloo ranks sharing card 0."""
    torch.cuda.set_device(0)
    out = {"launches": []}
    for key, name in (("dp3", "4m-respawn-stress"), ("dp2", "1m-flow")):
        launches, ms, moved, diffs, grids, diffs3 = rank_dp_identity(
            name, RANK_FRAMES, mode3=key == "dp2")
        out["launches"].append(launches)
        out[key] = dict(ms=ms, moved=moved, diffs=diffs, grids=grids,
                        diffs3=diffs3)
    launches, ms, moved, errs = rank_slab("1m-flow", RANK_FRAMES, rank,
                                          ranks)
    out["launches"].append(launches)
    out["slab2"] = dict(ms=ms, moved=moved, errs=errs)
    launches, ms, events, keys = rank_merge(MERGE_FRAMES)
    out["launches"].append(launches)
    out["merge3"] = dict(ms=ms, events=events, keys=keys)
    out["launches"] = sum_counts(out["launches"])
    return out


def gloo_ranks_4(rank, ranks):
    """Phase 17 (c), on each of 4 gloo ranks sharing card 0: the `(2, 2)`
    multi-host mesh against the flat mesh at config 2, this rank's state
    equal bit for bit."""
    from tendrils_tpu_torch.ops import cuda_lib
    from tendrils_tpu_torch.parallel import (ParallelTendrils, comm,
                                             make_mesh, make_multihost_mesh)
    torch.cuda.set_device(0)
    del rank, ranks
    out, sims, launches = {}, {}, []
    for label, mesh in (("flat", make_mesh()),
                        ("multihost", make_multihost_mesh(hosts=2))):
        eng = twin("1m-flow")[1]
        par = ParallelTendrils(eng, mesh)
        cuda_lib.reset_counts()
        comm.reset_counts()
        out[label] = dict(ms=timed(par.frame, RANK_FRAMES),
                          moved={k: v / RANK_FRAMES
                                 for k, v in comm.moved.items()})
        launches.append(dict(cuda_lib.launches))
        sims[label] = eng.sim
    out["equal"] = [f.name for f in dataclasses.fields(sims["flat"])
                    if isinstance(getattr(sims["flat"], f.name),
                                  torch.Tensor)
                    and torch.equal(getattr(sims["flat"], f.name),
                                    getattr(sims["multihost"], f.name))]
    out["launches"] = sum_counts(launches)
    return out


def check_k2_adds_rows():
    """K2 with `adds_rows` on a seeded config-2 stream: at adds_rows = 2n
    equal to its plain version bit for bit; its split conversion (three
    launches, then `splat_convert`) equal to the four-launch call; and two
    halves of the sorted stream, each at adds_rows = n, summing to the
    whole stream's int64 sums (the sharded draw's premise)."""
    from tendrils_tpu_torch.ops import draw_cuda
    n, hw = 1 << 20, (1080, 1920)
    s = sorted_streams(n, hw, 0.01, 17)
    kw = dict(idx_bits=20, samples=2, grid_hw=hw, pscale=s["pscale"])
    args = (s["scal"], s["keym_s"], s["p1_s"], s["vl_s"])
    got = draw_cuda.splat(*args, adds_rows=2 * n, **kw)
    equal_to_plain("K2 at adds_rows = 2n", got, draw_cuda.splat_plain(
        s["scal"], s["p1_s"], s["vl_s"], adds_rows=2 * n, **kw_plain(kw)))
    whole = draw_cuda.splat_planned(*args, **kw)[0]
    split = draw_cuda.splat_convert(s["scal"], whole, samples=2, adds_rows=n)
    if not torch.equal(split, draw_cuda.splat(*args, **kw)):
        fail("K2: the split conversion differs from the four-launch call")
    if torch.equal(split, got):
        fail("K2: adds_rows = 2n gave the steps of n")
    half = n // 2
    parts = [draw_cuda.splat_planned(args[0], *(a[rows] for a in args[1:]),
                                     adds_rows=n, **kw)[0]
             for rows in (slice(None, half), slice(half, None))]
    if not torch.equal(parts[0] + parts[1], whole):
        fail("K2: two halves' int64 sums at adds_rows = n do not add up "
             "to the whole stream's")
    print("[17] K2 with adds_rows on the seeded config-2 stream (1,048,576 "
          "rows): at adds_rows = 2n equal to its plain version bit for bit; "
          "the split conversion equal to the four-launch call; two halves' "
          "int64 sums at adds_rows = n add up to the whole stream's")


def run_multi_device(card):
    """Phase 17: the sharded frames on the card. (a) NCCL at world size 1,
    (b) 2 gloo ranks sharing the card (data-parallel at config 3 by
    identity against the single device, at config 2 within the mode-3
    rule, slab at config 2, the merge at config 3), (c) 4 gloo ranks (the
    (2, 2) multi-host mesh against the flat one), K2 with `adds_rows`.
    Returns the sharded runs' launch counts."""
    from tendrils_tpu_torch.parallel import dryrun
    t0 = time.perf_counter()
    check_k2_adds_rows()
    launches_a, payload = run_nccl_world1(card)
    t_a = time.perf_counter() - t0
    two = dryrun.spawn_ranks(gloo_ranks_2, 2, timeout=RANK_TIMEOUT)
    t_b = time.perf_counter() - t0 - t_a
    for r, res in enumerate(two):
        bad = {k: d for k, (eq, d) in res["dp3"]["diffs"].items() if not eq}
        if bad:
            fail(f"17 (b) config 3, rank {r}: not equal to the single "
                 f"device by identity: max |d| {bad}")
        d2, g2 = res["dp2"]["diffs"], res["dp2"]["grids"]
        if max(d2[k][1] for k in ("particles", "previous")) > MODE3_ATOL \
                or any(total > MODE3_MASS for _, total in g2.values()):
            fail(f"17 (b) config 2, rank {r}: beyond the mode-3 rule: "
                 f"{d2}, grids (share beyond, total) {g2}")
        bad = {k: d for k, (eq, d) in res["dp2"]["diffs3"].items()
               if not eq}
        if bad:
            fail(f"17 (b) config 2, rank {r}: not equal to the single "
                 f"device in gather mode 3 by identity: max |d| {bad}")
        ev = res["merge3"]["events"]
        if ev.get("reorder_merged", 0) + ev.get("reorder_fallback", 0) \
                != MERGE_FRAMES or ev.get("reorder_fallback", 0) < 1:
            fail(f"17 (b) merge, rank {r}: events {ev}")
    four = dryrun.spawn_ranks(gloo_ranks_4, 4, timeout=RANK_TIMEOUT)
    t_c = time.perf_counter() - t0 - t_a - t_b
    for r, res in enumerate(four):
        if not {"particles", "previous", "flow", "view", "force",
                "idx"} <= set(res["equal"]):
            fail(f"17 (c) rank {r}: the multi-host mesh's state differs "
                 f"from the flat mesh's (equal: {res['equal']})")
    med = statistics.median
    b0 = two[0]
    print(f"[17] (b) gloo, 2 ranks sharing the card: data-parallel at "
          f"config 3 (4m-respawn-stress, 4,194,304 particles, gather mode 3 "
          f"on both sides), {RANK_FRAMES} frames: every row by identity and "
          f"both grids equal bit for bit to the single device on each rank; "
          f"ms a frame, sharded / single, rank 0: " + ", ".join(
              f"{a:.1f}/{b:.1f}" for a, b in zip(*b0['dp3']['ms']))
          + f"; ring bytes a rank a frame {b0['dp3']['moved']}")
    print(f"[17] (b) data-parallel at config 2, {RANK_FRAMES} frames (a "
          f"shard in gather mode 3, one device in mode 1): max |d| by rank "
          + "; ".join(f"{r}: " + ", ".join(
              f"{k} {d:.3e}{' (equal)' if eq else ''}"
              for k, (eq, d) in res["dp2"]["diffs"].items())
              for r, res in enumerate(two))
          + f" (rows within atol {MODE3_ATOL}); texels beyond rtol 1e-4 / "
          f"atol 1e-5 and relative total difference, rank 0: " + ", ".join(
              f"{k} {a:.3e} {t:.3e}" for k, (a, t) in
              b0["dp2"]["grids"].items())
          + f" (totals within {MODE3_MASS}); against one device forced "
          f"into gather mode 3, every row by identity and both grids equal "
          f"bit for bit on each rank; ms a frame, sharded / "
          f"single, rank 0: " + ", ".join(
              f"{a:.1f}/{b:.1f}" for a, b in zip(*b0['dp2']['ms']))
          + f"; ring bytes a rank a frame {b0['dp2']['moved']}")
    print(f"[17] (b) slab at config 2, {RANK_FRAMES} frames: within "
          f"rtol/atol {SLAB_TOL} of the single device on each rank (max "
          f"|d| rank 0: " + ", ".join(f"{k} {v:.3e}" for k, v in
                                     b0["slab2"]["errs"].items())
          + "); ms a frame rank 0: " + ", ".join(
              f"{v:.1f}" for v in b0["slab2"]["ms"])
          + f"; ring bytes a rank a frame {b0['slab2']['moved']}")
    print(f"[17] (b) the merge reorder at config 3, {MERGE_FRAMES} frames "
          f"on 2,097,152 rows a rank: " + "; ".join(
              f"rank {r}: {res['merge3']['events']}, ms a frame "
              + ", ".join(f"{v:.1f}" for v in res["merge3"]["ms"])
              for r, res in enumerate(two)))
    c0 = four[0]
    print(f"[17] (c) gloo, 4 ranks sharing the card: the (2, 2) multi-host "
          f"mesh at config 2, {RANK_FRAMES} frames, equal bit for bit to the "
          f"flat mesh on every rank ({', '.join(c0['equal'])}); ms a frame "
          f"rank 0, flat / multi-host: " + ", ".join(
              f"{a:.1f}/{b:.1f}" for a, b in zip(c0["flat"]["ms"],
                                                 c0["multihost"]["ms"]))
          + f"; ring bytes a rank a frame {c0['flat']['moved']}")
    total = sum_counts([launches_a] + [r["launches"] for r in two + four])
    print(f"[17] multi-device phase in {time.perf_counter() - t0:.1f} s "
          f"((a) {t_a:.1f}, (b) {t_b:.1f}, (c) {t_c:.1f}); launches of "
          f"the sharded runs, all ranks: {total} ({card})")
    return total


def lap(laps, name, fn, *args):
    """`fn(*args)`, its wall seconds kept in `laps[name]`."""
    t0 = time.perf_counter()
    out = fn(*args)
    laps[name] = time.perf_counter() - t0
    return out


def main():
    t_start = time.perf_counter()
    laps = {}
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

    from tendrils_tpu_torch.ops import cuda_lib, draw_cuda, splat_cuda
    if "jax" in sys.modules:
        fail("the port imported jax")
    if draw_cuda.SPLAT_LAUNCHES != K2 \
            or splat_cuda.SPLAT_POINTS_LAUNCHES != K9:
        fail(f"K2 launches {draw_cuda.SPLAT_LAUNCHES} kernels a call and K9 "
             f"{splat_cuda.SPLAT_POINTS_LAUNCHES}, the path tables count "
             f"{K2} and {K9}")

    t0 = time.perf_counter()
    cuda_lib.library()
    built = cuda_lib.build_seconds
    release = subprocess.run([cuda_lib._nvcc(), "--version"],
                             capture_output=True, text=True).stdout
    print(f"[2] kernels built in {time.perf_counter() - t0:.1f} s "
          f"(nvcc {'cached' if built is None else f'{built:.1f} s'}; "
          f"{release.strip().splitlines()[-1]})")
    laps["1-2 start, build"] = time.perf_counter() - t_start

    print("[3] kernels vs plain versions at config-2 shapes:")
    for kind in ("write", "read"):
        _, ms, names = l2_flush(kind)
        print(f"  cold timings' L2 {kind} flush: {ms:.4f} device ms alone, "
              "left out by name (" + "; ".join(
                  k.split("(")[0][-60:] for k in names) + ")")
    checks = lap(laps, "3 config 2", check_config2_kernels)
    print("[3] kernels vs plain versions at config-4 shapes:")
    checks.update(lap(laps, "3 config 4", check_config4_kernels))
    print("[3] the K1/K2 variants with p0 and rgba8 streams, K7 and K12:")
    checks.update(lap(laps, "3 variants", check_slice3_kernels))
    print("[3] K2 on real and long-segment streams, K7 on a real classic "
          "frame's and path B's:")
    lap(laps, "3 K2 streams", check_splat_streams)
    lap(laps, "3 K7 frames", check_k7_real_frame)
    print("[3] K5 at config-3 and config-5 shapes:")
    lap(laps, "3 K5", check_k5_configs)
    print("[3] the merge reorder (K10, K11) and K2 on real frames' inputs, "
          "and K1 in gather modes 3 and 2 at config-3 shapes:")
    checks.update(lap(laps, "3 merge", check_merge_kernels))
    print("[3] K2 and K3 view-only (flow_off) on config-1 and config-2 "
          "streams:")
    checks.update(lap(laps, "3 view-only", check_view_only_kernels))
    print("[3] K13, the logic step, at config-2 and config-5 shapes:")
    checks.update(lap(laps, "3 K13", check_logic_kernel))

    eng, launches2, ms2 = lap(laps, "4 config 2", run_config2)
    names = lap(laps, "5 replay", replay, eng, eng.frame, "1m-flow")
    print(f"[5] 1m-flow frame replayed: {', '.join(names)} equal bit for "
          "bit")
    del eng
    lap(laps, "5 replay io", replay_io)
    launches4, ms4 = lap(laps, "6 config 4", run_config4)
    launches_a = lap(laps, "7 path A", run_path_a)
    launches_bc = lap(laps, "8 paths B, C", run_paths_b_c)
    launches_m2 = lap(laps, "9 merge config 2", run_merge_config2)
    eng3, launches_m3 = lap(laps, "9 merge config 3", run_merge_config3)
    lap(laps, "5 replay respawn", replay_respawn, eng3)
    launches_big, eng5, headless5 = lap(laps, "10 config 5",
                                        run_config5_and_mode2, eng3)
    del eng3
    launches_1 = lap(laps, "12 config 1", run_config1)
    launches_show = lap(laps, "13 show frame", run_show_frame, eng5,
                        headless5)
    launches_t5 = lap(laps, "14 targets config 5", run_targets_config5,
                      eng5, headless5)
    del eng5
    eng2, launches_t2 = lap(laps, "14 spawns, targets config 2",
                            run_spawns_config2, ms2)
    launches_t4 = lap(laps, "14 targets config 4", run_targets_config4, ms4)
    launches_f = lap(laps, "14 facade helpers", run_facade_helpers, eng2)
    del eng2
    torch.cuda.empty_cache()
    launches_demo = lap(laps, "15 demo", run_demo, ms4)
    launches_g, k9_row = lap(laps, "16 generic", run_generic, card, ms2)
    checks.update(k9_row)
    # Phase 16's K9 launches count under the generic draw's row.
    launches_g["splat_points_generic"] = launches_g.pop("splat_points", 0)
    launches_md = lap(laps, "17 multi-device", run_multi_device, card)
    if "jax" in sys.modules:
        fail("the port imported jax")

    runs = (launches2, launches4, launches_a, launches_bc, launches_m2,
            launches_m3, launches_big, launches_1, launches_show,
            launches_t5, launches_t2, launches_t4, launches_f, launches_demo,
            launches_g, launches_md)
    print(f"[18] every phase passed in {time.perf_counter() - t_start:.1f} "
          f"s; {TRACES['traces']} profiler traces, "
          f"{TRACES['traced again']} of them taken again; seconds by "
          f"phase: " + ", ".join(f"{k} {v:.1f}" for k, v in laps.items()))
    print(card)
    print(json.dumps({"kernels": [
        {"name": k, "route": "cuda", "source": src, "replaces": rep,
         "launches": sum(r.get(k, 0) for r in runs),
         **{key: checks[k][key] for key in (
             "max_abs_err", "ms", "cold_ms", "cold_clean_ms", "call_ms",
             "plain_ms", "bound_ms", "bound_by", "library_ms")}}
        for k, (src, rep) in KERNELS.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
