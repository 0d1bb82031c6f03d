"""One run of one cell: set-up, the measured window, the check against the
plain reference, and the result line.

`run_cell` does the work on any device (the tests drive it on the CPU at a
tiny size); `main` is the benchmark's command, which refuses to run without
the card the cell asks for.
"""

from __future__ import annotations

import argparse
import gc
import json
import math
import subprocess
import sys
import time
from pathlib import Path
from typing import Optional

import torch

from portbench import check, spec
from portbench.weights import SeededWeights

FORBIDDEN = ("jax", "jaxlib", "flax", "aigv_assessor_tpu")
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def forbidden_modules() -> list:
    """Loaded modules whose whole top-level name is a forbidden one."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


class Run:
    """A run's inputs, and what its driver records."""

    def __init__(self, cell: spec.Cell, seed: int, seconds: float, trace: bool,
                 device, t_start: float):
        self.cell, self.seed, self.seconds, self.trace = cell, seed, seconds, trace
        self.cfg = cell.config
        self.device = torch.device(device)
        self.dtype = DTYPES[self.cfg.get("torch_dtype", "bfloat16")]
        self.t_start = t_start
        self.weights = SeededWeights(self.cfg, seed, self.device, self.dtype)
        self.setup_s = self.window_s = None
        self.attempted = self.failed = 0
        self.peak_bytes = 0
        self.raw: dict = {}
        self.compare: dict = {}
        self.phases: dict = {}  # set-up seconds by phase, as `mark` closes each
        self._last = t_start
        self.mark("start")  # imports, CUDA, the kernels' build or load

    def mark(self, phase: str) -> None:
        now = time.perf_counter()
        self.phases[phase] = now - self._last
        self._last = now

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def program_config(self):
        from aigv_assessor_torch.core.config import AssessorConfig

        return AssessorConfig.from_dict(self.cfg)

    def build_model(self):
        """The program's serving model, its weights from the benchmark's draw."""
        from aigv_assessor_torch.cli.common import build_serving_model
        from aigv_assessor_torch.core.precision import Precision

        precision = Precision() if self.dtype == torch.bfloat16 else Precision.fp32()
        model = build_serving_model(self.program_config(), device=self.device,
                                    precision=precision, weights=self.weights)
        self.weights.release()
        self.sync()
        self.mark("model")
        return model

    def start_window(self) -> None:
        self.sync()
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)
        self.mark("warmup")
        self.setup_s = time.perf_counter() - self.t_start

    def end_window(self) -> None:
        self.sync()
        if self.device.type == "cuda":
            self.peak_bytes = torch.cuda.max_memory_allocated(self.device)


def build_kernels() -> float:
    """Build the CUDA source every bf16 scoring path runs (the attention
    forward) into the program's fixed build directory inside the checkout,
    first in set-up. A kernel only another path runs
    builds at its first use, in that cell's warm-up. Returns the seconds
    nvcc took (0 when the library was already built)."""
    from aigv_assessor_torch.ops import cuda_build
    from aigv_assessor_torch.ops import flash_attention as fa

    return cuda_build.build([fa.LIB])


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool, device,
             t_start: Optional[float] = None, control: bool = False) -> dict:
    """One run -> the result line's object (`correct`, `attempted`,
    `failed`, `metrics`, `device`, with `trace` a `breakdown`, last
    `check`). `control` adds 'control', the numbers of the fp8 reference
    put in the program's place on the same compared inputs, and 'numbers',
    every number the program's run read, held or not."""
    r = Run(cell, seed, seconds, trace, device,
            time.perf_counter() if t_start is None else t_start)
    cell.driver().run(r)
    gc.collect()
    if r.device.type == "cuda":
        torch.cuda.empty_cache()
    ref32 = check.reference_outputs(r.cfg, r.weights, r.compare, r.device)
    numbers = check.gaps(r.compare["program"], ref32)
    correct = (r.failed == 0 and r.attempted > 0
               and all(check.within(numbers.get(k), lim) for k, lim in cell.limits.items()))
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = m.read(r)
        if value is not None and math.isfinite(value):
            metrics[m.name] = {"value": value, "unit": m.unit}
    dev = {"platform": "gpu" if r.device.type == "cuda" else r.device.type,
           "kind": torch.cuda.get_device_name(r.device) if r.device.type == "cuda" else "cpu",
           "count": 1, "memory_peak_bytes": int(r.peak_bytes)}
    out = {"correct": bool(correct), "attempted": int(r.attempted), "failed": int(r.failed),
           "metrics": metrics, "device": dev}
    summary = r.raw.get("summary")
    if trace and summary is not None:
        dev["busy_s"] = summary["busy_s"]
        dev["window_s"] = summary["window_s"]
        out["breakdown"] = summary["breakdown"]
    out["setup_phases"] = r.phases
    if control:
        ref8 = check.reference_outputs(r.cfg, r.weights, r.compare, r.device, fp8=True)
        out["control"] = check.control_gaps(r.compare["program"], ref8, ref32)
        out["numbers"] = numbers
    out["check"] = {k: {"value": numbers.get(k), "limit": lim} for k, lim in cell.limits.items()}
    return out


def _card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi not readable"


def main(argv=None, t_start: Optional[float] = None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    ap = argparse.ArgumentParser(description="Run one cell of BENCHMARK.json once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    cell = spec.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: {args.workload} needs {cell.chips} CUDA card(s); found {n}",
              file=sys.stderr)
        return 2
    print(f"portbench: card {_card_line()}", file=sys.stderr)
    compile_s = build_kernels()
    if compile_s:
        print(f"portbench: nvcc built the kernels in {compile_s:.1f} s", file=sys.stderr)
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda:0", t_start=t_start)
    found = forbidden_modules()
    if found:
        print(f"portbench: the run loaded {found}", file=sys.stderr)
        return 3
    print(f"portbench: set-up seconds by phase {json.dumps(out.pop('setup_phases'))}",
          file=sys.stderr)
    for name, c in out["check"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0
