"""Run one cell of the benchmark once, on the card it is started on:

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. The cell, its configuration, traffic mix,
metrics and limits are found by name (`BENCHMARK.json`, `benchmark/`).
The last line of standard output is the result, one JSON object; the
lines before it on standard error say what ran, on which card, and end
with each compared number beside its limit. With `--trace 0` the result
holds the cell's end-to-end metrics, with `--trace 1` its per-layer
metrics. A run exits non-zero and prints no result where no card (or too
few) is visible, and where JAX, jaxlib, flax or the JAX package
`tendrils_tpu` was loaded.

The kernels' build (nvcc, `build/tendrils_tpu_torch/` inside the
checkout) and CUDA's own cache (`CUDA_CACHE_PATH`, `build/cuda_cache/`)
stay inside the checkout, at fixed paths.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "tendrils_tpu")


def forbidden_modules(modules=None):
    """The loaded modules whose top-level name, the part before the first
    dot, is one of FORBIDDEN, compared whole."""
    modules = sys.modules if modules is None else modules
    return sorted(m for m in modules if m.split(".")[0] in FORBIDDEN)


def finite(x):
    """`x` with each non-finite float as 1e300 (JSON has no infinity)."""
    if isinstance(x, float) and not math.isfinite(x):
        return 1e300
    if isinstance(x, dict):
        return {k: finite(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [finite(v) for v in x]
    return x


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    os.environ.setdefault("CUDA_CACHE_PATH",
                          str(ROOT / "build" / "cuda_cache"))
    sys.path.insert(0, str(ROOT))
    import torch
    from benchmark import cell, harness

    c = cell.load(args.workload)
    lib = harness.program_lib()
    if not torch.cuda.is_available():
        print("bench: no CUDA device is visible", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < c.chips:
        print(f"bench: the cell needs {c.chips} cards, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    torch.cuda.set_device(0)
    result, _, _ = harness.run(c, args.seed, args.seconds, bool(args.trace),
                               T0, lib=lib)
    bad = forbidden_modules()
    if bad:
        print(f"bench: modules of JAX or the JAX package were loaded: {bad}",
              file=sys.stderr)
        return 3
    for name, chk in result["checks"].items():
        print(f"check {name}: {chk['value']!r} limit {chk['limit']!r}",
              file=sys.stderr)
    print(json.dumps(finite(result)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
