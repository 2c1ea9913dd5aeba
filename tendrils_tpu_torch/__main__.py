"""CLI runner — the headless analog of `src/demo-run.main.js` (boot the demo
on load) plus the export path the browser build lacks.

    python -m tendrils_tpu_torch [--preset NAME] [--frames N] [--out DIR]
                                 [--res HxW] [--root N] [--device cuda|cpu]
                                 [--setting key=value ...]

Runs the demo app headlessly and writes PNG frames (and a final
checkpoint), replaying any preset deterministically at the fixed timestep.
The port of `tendrils_tpu/__main__.py`, with its flags and its final JSON
line. It runs on the CUDA device unless `--device cpu` is given (there
every kernel takes its plain PyTorch version). `--backend` sets the splat
and gather backends: "kernel" (the default), the fused draw on the
hand-written kernels (the JAX CLI's "pallas"), or "xla", the generic draw
in plain PyTorch (the JAX CLI's "xla", its choice off a TPU).
"""

import argparse
import json
import os
import sys
import time


def main(argv=None):
    ap = argparse.ArgumentParser(prog="tendrils_tpu_torch",
                                 description=__doc__)
    ap.add_argument("--preset", default=None, help="preset name to apply")
    ap.add_argument("--frames", type=int, default=120)
    ap.add_argument("--out", default="out", help="output directory")
    ap.add_argument("--res", default="720x1280", help="HxW view resolution")
    ap.add_argument("--root", type=int, default=None,
                    help="rootNum (particles = rootNum^2); default by "
                         "quality tier")
    ap.add_argument("--every", type=int, default=1,
                    help="write every Nth frame")
    ap.add_argument("--quality", type=int, default=0)
    ap.add_argument("--backend", default="kernel", choices=["kernel", "xla"],
                    help="splat and gather backend (default kernel)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default cuda)")
    ap.add_argument("--checkpoint", default=None,
                    help="resume from this checkpoint before running")
    ap.add_argument("--list-presets", action="store_true")
    ap.add_argument("--setting", action="append", default=[],
                    metavar="KEY=VALUE", help="querystring-style setting")
    args = ap.parse_args(argv)

    from tendrils_tpu_torch.app import PRESETS, TendrilsDemo
    from tendrils_tpu_torch.io import (load_checkpoint, save_checkpoint,
                                       save_png, view_to_u8)

    if args.list_presets:
        print("\n".join(PRESETS))
        return 0

    h, w = (int(v) for v in args.res.split("x"))
    settings = dict(s.split("=", 1) for s in args.setting)
    settings.setdefault("quality", str(args.quality))
    if args.preset:
        settings["preset"] = args.preset

    kw = dict(view_res=(h, w), splat_backend=args.backend,
              gather_backend=args.backend,
              flow_samples=2, flow_rows=1, view_samples=2)
    if args.root:
        kw["root_num"] = args.root
    demo = TendrilsDemo(settings, device=args.device, **kw)
    if args.root:
        demo.quality["options"][demo.quality["level"]]["rootNum"] = args.root
        demo.quality_change(demo.quality["level"])
        if args.preset:
            demo.apply_preset(args.preset)
    if args.checkpoint:
        load_checkpoint(args.checkpoint, demo.tendrils)

    os.makedirs(args.out, exist_ok=True)
    t0 = time.time()
    for i in range(args.frames):
        demo.render()
        if i % args.every == 0:
            img = view_to_u8(demo.screen_image.cpu().numpy())
            save_png(os.path.join(args.out, f"frame_{i:05d}.png"), img)
    elapsed = time.time() - t0

    save_checkpoint(os.path.join(args.out, "final.ckpt.npz"), demo.tendrils)
    n = demo.tendrils.config.n
    print(json.dumps({
        "frames": args.frames,
        "particles": n,
        "ms_per_frame": round(elapsed / args.frames * 1000, 2),
        "particle_steps_per_sec": round(n * args.frames / elapsed),
        "out": args.out,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
