"""The readings that the check's limits are set from, on the card:

    python3 benchmark/readings.py --workload <name> --seeds 1,2,... \
        [--control-seeds 7,8,9] [--fault step_unchanged,...] [--seconds 2]

For each seed, in one process, a run of the cell (a short window at the
cell's own size, `harness.run`) and its compared numbers, the program's
against the plain reference; for each control seed, the numbers of each
control in the program's place (`reference`: "bf16", "draw-bf16"); then,
for each fault (`faults.NAMES`), a run on each control seed with the
fault planted under the timed path. One JSON line a run on standard
output, then, number by number, the largest of the program's readings
and the smallest of each control's and each fault's. The benchmark's own
runs run none of these.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
CONTROLS = ("bf16", "draw-bf16")


def names(text):
    return [s for s in text.split(",") if s]


def seeds(text):
    return [int(s) for s in names(text)]


def _least(into, numbers):
    for k, v in numbers.items():
        into[k] = min(into.get(k, float("inf")), v)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=seeds, default=[])
    p.add_argument("--control-seeds", type=seeds, default=[])
    p.add_argument("--fault", type=names, default=[])
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch
    from benchmark import cell, faults, harness

    c = cell.load(args.workload)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("readings: no CUDA device is visible", file=sys.stderr)
        return 2
    lower, upper = {}, {}
    runs = [(s, s in args.control_seeds, None) for s in args.seeds]
    runs += [(s, True, None) for s in args.control_seeds
             if s not in args.seeds]
    runs += [(s, False, f) for f in args.fault for s in args.control_seeds]
    for seed, control, fault in runs:
        undo = faults.plant(fault) if fault else None
        try:
            result, numbers, ctl = harness.run(
                c, seed, args.seconds, False, time.perf_counter(),
                device=args.device, controls=CONTROLS if control else ())
        finally:
            if undo:
                undo()
        if fault:
            _least(upper.setdefault(fault, {}), numbers)
        elif seed in args.seeds:
            for k, v in numbers.items():
                lower[k] = max(lower.get(k, 0.0), v)
        for kind, nums in ctl.items():
            _least(upper.setdefault(kind, {}), nums)
        print(json.dumps({"seed": seed, "fault": fault,
                          "correct": result["correct"],
                          "frames": result["attempted"], "program": numbers,
                          "controls": ctl}), flush=True)
    print(json.dumps({"workload": c.name, "lower": lower, "upper": upper}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
