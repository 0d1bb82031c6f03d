"""fp8 (e4m3) weight streaming for decode on the card: the port of
`benchmarks/fp8_decode_probe.py`.

    python -m aigv_assessor_torch.tools.fp8_decode_probe [--iters 20]

Four candidates on InternLM2-1.8B's decode matvec shapes at full width
(wqkv 2048 -> 4096, w1 / w3 fused 2048 -> 16384, w2 8192 -> 2048), for M = 8
decode rows (the probe's) and M = 1 and 4, weights normal(0, 0.02) from a
seed:

- `xla_bf16`: `F.linear` on the bf16 weight, the control;
- `xla_fp8`: `F.linear(x, w8.to(bf16)) * scale.bf16`, the weight upcast into
  device memory first;
- `pallas_fp8`: `ops/fp8_matmul.fp8_matmul`, the e4m3 kernel (K9);
- `int4`: `ops/int8_matmul.int4_matmul` on the port's [N, ceil(K/2)]
  packing (K7).

The names are the probe's keys. For each it prints the relative error
against the float product (largest difference over the largest value, as
the probe measures it), the device time per call in microseconds and the
weight bytes streamed per second; then one JSON line with the probe's keys
at M = 8 (`{shape}_fp8_rel_err`, `{shape}_{candidate}_us`,
`{shape}_{candidate}_gbps`), the same at M = 1 and 4 under `{shape}_m{M}_`,
and the card's name and power limit.

Timing: a candidate's calls over enough copies of its weights that together
they exceed the L2 cache, as a decoder walking its layers finds them, are
captured into one CUDA graph and replayed; the time is the replay's over the
number of calls (CUDA events), so the host's launch cost is not in it. This
replaces the probe's chained slope, a jit loop of dependent calls on the
TPU. Needs a CUDA card; there is no CPU mode.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

import torch
import torch.nn.functional as F

from aigv_assessor_torch.ops.fp8_matmul import fp8_matmul, quantize_weight_fp8
from aigv_assessor_torch.ops.int8_matmul import int4_matmul, quantize_kernel_int4

SHAPES = {  # name: (K, N), the probe's
    "wqkv_2048x4096": (2048, 4096),
    "w13_2048x16384": (2048, 16384),
    "w2_8192x2048": (8192, 2048),
}
ROWS = (8, 1, 4)  # decode rows; 8 is the probe's
WEIGHT_BYTES = {"xla_bf16": 2.0, "xla_fp8": 1.0, "pallas_fp8": 1.0, "int4": 0.5}
L2_BYTES = 50e6


def graph_us(fns, iters: int) -> float:
    """Device time per call of `fns`, captured into one CUDA graph and
    replayed `iters` times after a warm-up. -> microseconds."""
    fns[0]()  # builds and warms up outside the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for fn in fns:
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters / len(fns) * 1e3


def candidates(wf: torch.Tensor) -> dict:
    """{name: (fn(x, *weights), weights)} for a float weight [N, K]."""
    w8, s8 = quantize_weight_fp8(wf)
    w4, s4 = quantize_kernel_int4(wf)
    return {
        "xla_bf16": (lambda x, w: F.linear(x, w), (wf.to(torch.bfloat16),)),
        "xla_fp8": (lambda x, w, s: F.linear(x, w.to(torch.bfloat16)) * s.to(torch.bfloat16),
                    (w8, s8)),
        "pallas_fp8": (fp8_matmul, (w8, s8)),
        "int4": (int4_matmul, (w4, s4)),
    }


def run(shapes=SHAPES, rows=ROWS, iters: int = 20, seed: int = 0, verbose: bool = True) -> dict:
    """The probe's measurement on the current CUDA card -> its report dict."""
    if not torch.cuda.is_available():
        raise RuntimeError("fp8_decode_probe needs a CUDA card")
    device = torch.device("cuda")
    gen = torch.Generator(device=device).manual_seed(seed)
    report = {}
    for name, (k, n) in shapes.items():
        wf = torch.randn((n, k), generator=gen, device=device) * 0.02
        cands = candidates(wf)
        for m in rows:
            x = torch.randn((m, k), generator=gen, device=device).to(torch.bfloat16)
            y_ref = x.float() @ wf.t()
            key = name if m == 8 else f"{name}_m{m}"
            for cname, (fn, weights) in cands.items():
                y = fn(x, *weights).float()
                rel = ((y - y_ref).abs().max() / y_ref.abs().max().clamp_min(1e-9)).item()
                nbytes = sum(w.numel() * w.element_size() for w in weights)
                copies = int(2 * L2_BYTES // nbytes) + 1
                sets = [weights] + [tuple(w.clone() for w in weights) for _ in range(copies - 1)]
                us = graph_us([lambda ws=ws: fn(x, *ws) for ws in sets], iters)
                gbps = k * n * WEIGHT_BYTES[cname] / (us * 1e-6) / 1e9
                report[f"{key}_{cname}_us"] = us
                report[f"{key}_{cname}_gbps"] = gbps
                report[f"{key}_{cname}_rel_err"] = rel
                if cname == "pallas_fp8":  # the probe's own key
                    report[f"{key}_fp8_rel_err"] = rel
                if verbose:
                    print(f"{name} M={m} {cname}: rel err {rel:.3e}, {us:.2f} us, "
                          f"{gbps:.1f} GB/s of weight ({copies} weight copies)", flush=True)
                del sets
    return report


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--iters", type=int, default=20)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("fp8_decode_probe needs a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    report = run(iters=args.iters)
    report["device"] = torch.cuda.get_device_name(0)
    report["nvidia_smi"] = smi
    print(json.dumps(report), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
