"""The readings that the limits of `correct` are set from, on the card.

    python3 portbench/calibrate.py --workload <cell> --seconds <s> --seeds <n> [<n> ...]
        [--control-seeds <n> ...]

One process builds the kernels once, then runs the cell once per seed
(`harness.run_cell`, a short window at the cell's own load and the same
comparison a benchmark run makes), and on each control seed also puts the
fp8 reference in the program's place on the same compared inputs. Prints a
JSON line per run ('check' values, 'control' where run, the end-to-end
metrics) and last the largest reading of each number over the seeds
('lower') and the smallest of the control ('upper').
"""

import sys
import time
from pathlib import Path

sys.path[0] = str(Path(__file__).resolve().parents[1])

import argparse  # noqa: E402
import json  # noqa: E402

import torch  # noqa: E402

from portbench import harness, spec  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA card", file=sys.stderr)
        return 2
    cell = spec.load_cell(args.workload)
    compile_s = harness.build_kernels()
    print(f"calibrate: nvcc built the kernels in {compile_s:.1f} s", file=sys.stderr)
    lower, upper = {}, {}
    for seed in dict.fromkeys(args.seeds + args.control_seeds):
        t0 = time.perf_counter()
        out = harness.run_cell(cell, seed, args.seconds, False, "cuda:0",
                               control=seed in args.control_seeds)
        line = {"seed": seed, "correct": out["correct"], "run_s": time.perf_counter() - t0,
                "metrics": {k: v["value"] for k, v in out["metrics"].items()},
                "check": out.get("numbers") or {k: v["value"] for k, v in out["check"].items()},
                "control": out.get("control")}
        print(json.dumps(line), flush=True)
        if seed in args.seeds:
            for k, v in line["check"].items():
                lower[k] = max(lower.get(k, 0.0), v)
        for k, v in (out.get("control") or {}).items():
            upper[k] = min(upper.get(k, float("inf")), v)
    print(json.dumps({"workload": args.workload, "lower": lower, "upper": upper,
                      "ratio": {k: upper[k] / lower[k] for k in upper if lower.get(k)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
