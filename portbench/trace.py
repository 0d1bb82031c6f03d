"""From a `torch.profiler` window to the traced run's numbers.

`profile_window` wraps the measured window in a profiler and a
`record_function` range named `WINDOW`; `summarize` reads the Chrome trace
it exports:

- the device's busy time: the union of kernel, memcpy and memset intervals
  inside the window (so the idle share is the window less that union, not
  "device time against wall time", which would count the profiler's own
  overhead as idle);
- device time by kind of kernel (`kind_of`, a frozen copy of the port's
  `tools/profile_score.KINDS` table);
- device time by hooked module: each kernel goes, through its launch's
  correlation id, to the innermost `record_function` range named
  `MODULE_PREFIX + module` that holds the launch on the host;
- the breakdown: the device operations that took most time, and the idle
  gaps summed by what the launching host thread was doing when each began.
"""

from __future__ import annotations

import bisect
import contextlib
import json
import os
import tempfile
from collections import defaultdict
from typing import Dict, Iterable, List, Optional, Tuple

WINDOW = "portbench.window"
MODULE_PREFIX = "portbench.module."
# the program's modules whose calls the traced runs mark
MODULES = ("vision_model", "mlp1", "slowfast_model", "motion_mlp", "language_model", "mlpscore")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
GAP_LABEL_US = 50.0  # shorter gaps are summed under one label
TOP = 10

KINDS = (  # (label, substrings of the kernel's name)
    ("decode_attention", ("decode_attention",)),
    ("attention_fwd", ("flash_fwd_",)),
    ("attention_bwd", ("flash_bwd_",)),
    ("weight_only_matmul", ("weight_only_", "int8weights", "int4weights")),
    ("quantize_feeds", ("quant_rows_kernel",)),
    ("gemm", ("gemm", "gemv", "nvjet", "cutlass", "cublas")),
    ("cudnn", ("cudnn", "conv")),
)


def kind_of(name: str) -> str:
    low = name.lower()
    for label, needles in KINDS:
        if any(n in low for n in needles):
            return label
    return "elementwise_and_other"


def union_length(intervals: Iterable[Tuple[float, float]]) -> Tuple[float, List[Tuple[float, float]]]:
    """Length of the union of [start, end) intervals, and the merged intervals."""
    merged: List[List[float]] = []
    for s, e in sorted(intervals):
        if e <= s:
            continue
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return sum(e - s for s, e in merged), [(s, e) for s, e in merged]


class _Innermost:
    """The innermost of properly nested host ranges holding a time."""

    def __init__(self, ranges: List[Tuple[float, float, str]]):
        self.ranges = sorted(ranges)
        self.starts = [r[0] for r in self.ranges]

    def at(self, t: float, max_walk: int = 20000) -> Optional[str]:
        i = bisect.bisect_right(self.starts, t) - 1
        walked = 0
        while i >= 0 and walked < max_walk:
            s, e, name = self.ranges[i]
            if e > t:
                return name
            i -= 1
            walked += 1
        return None


def summarize(events: List[dict]) -> dict:
    """The traced window's numbers from Chrome trace events (times in us)."""
    window = [e for e in events if e.get("name") == WINDOW and e.get("ph") == "X"
              and e.get("cat") != "gpu_user_annotation"]
    if not window:
        raise ValueError(f"no {WINDOW!r} range in the trace")
    w0 = float(window[0]["ts"])
    w1 = w0 + float(window[0]["dur"])

    def clip(e) -> Optional[Tuple[float, float]]:
        s, t = float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0))
        s, t = max(s, w0), min(t, w1)
        return (s, t) if t > s else None

    device = [e for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
    spans = [(c, e) for e in device if (c := clip(e)) is not None]
    busy_us, merged = union_length(c for c, _ in spans)

    launches = [e for e in events if e.get("ph") == "X"
                and e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "correlation" in e.get("args", {})]
    by_corr = {e["args"]["correlation"]: e for e in launches}
    tid_count: Dict[object, int] = defaultdict(int)
    for e in launches:
        tid_count[(e.get("pid"), e.get("tid"))] += 1
    host_thread = max(tid_count, key=tid_count.get) if tid_count else None

    annotations = [e for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    modules = _Innermost([(float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                           e["name"][len(MODULE_PREFIX):])
                          for e in annotations if e["name"].startswith(MODULE_PREFIX)])

    by_kind: Dict[str, float] = defaultdict(float)
    by_module: Dict[str, float] = defaultdict(float)
    by_name: Dict[str, float] = defaultdict(float)
    for (s, t), e in spans:
        dur = (t - s) / 1e6
        by_name[e["name"]] += dur
        if e.get("cat") != "kernel":
            by_kind["memcpy_memset"] += dur
            continue
        by_kind[kind_of(e["name"])] += dur
        launch = by_corr.get(e.get("args", {}).get("correlation"))
        module = modules.at(float(launch["ts"])) if launch is not None else None
        by_module[module or "other"] += dur

    host = [e for e in events if e.get("ph") == "X"
            and (e.get("pid"), e.get("tid")) == host_thread
            and e.get("cat") in ("user_annotation", "cpu_op", "cuda_runtime", "cuda_driver")
            and e.get("name") != WINDOW]
    host_at = _Innermost([(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
                          for e in host])
    gaps: Dict[str, float] = defaultdict(float)
    edges = [w0] + [x for iv in merged for x in iv] + [w1]
    for s, t in zip(edges[::2], edges[1::2]):
        if t <= s:
            continue
        if t - s < GAP_LABEL_US:
            gaps[f"(gaps under {GAP_LABEL_US:g} us)"] += (t - s) / 1e6
        else:
            gaps[host_at.at(s) or "(host: outside any range)"] += (t - s) / 1e6

    def top(d: Dict[str, float]) -> List[list]:
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]

    return {
        "window_s": (w1 - w0) / 1e6,
        "busy_s": busy_us / 1e6,
        "kernels": sum(1 for _, e in spans if e.get("cat") == "kernel"),
        "by_kind": dict(by_kind),
        "by_module": dict(by_module),
        "breakdown": {"device_ops": top(by_name), "idle_gaps": top(gaps)},
    }


@contextlib.contextmanager
def profile_window(enabled: bool):
    """Profile the block (CPU and CUDA activity) inside a `WINDOW` range.
    Yields a dict that holds, after the block, 'summary' (`summarize`)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    out: dict = {}
    if not enabled:
        yield out
        return
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW):
            yield out
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
    finally:
        os.unlink(path)
    out["summary"] = summarize(trace["traceEvents"] if isinstance(trace, dict) else trace)


def hook_modules(model, names: Iterable[str]):
    """Forward pre- and post-hooks on `model`'s submodules `names` that open
    and close a `record_function` range `MODULE_PREFIX + name` around each
    call. Returns the hook handles."""
    from torch.autograd.profiler import record_function

    handles = []
    for name in names:
        module = model.get_submodule(name)
        ranges: list = []

        def pre(mod, args, _ranges=ranges, _name=name):
            r = record_function(MODULE_PREFIX + _name)
            r.__enter__()
            _ranges.append(r)

        def post(mod, args, output, _ranges=ranges):
            _ranges.pop().__exit__(None, None, None)

        handles.append(module.register_forward_pre_hook(pre))
        handles.append(module.register_forward_hook(post))
    return handles
