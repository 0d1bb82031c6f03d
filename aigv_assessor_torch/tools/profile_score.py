"""Where one scoring chunk spends its time on the card, per serving precision.

    python -m aigv_assessor_torch.tools.profile_score [--modes bf16 w8a8 w8a8_fused int8 int4]
        [--config CONFIG.json]

For each mode it builds the InternVL2-2B serving model from a seed (or the
model of a reference-format `config.json`, `--config`, e.g. InternVL2-26B's)
(`cli/score.build_serving_model`; `w8a8_fused` is W8A8 with every feed fused,
`Precision.fuse_quant` and `quant_rows` at {"vit", "llm"}) and scores one synthetic chunk of 4 videos
x 8 frames x 448 px with a 2113-token prompt, the shapes `chip_smoke.py`
scores at. After a warm-up it prints, as JSON lines:

- with CUDA events over `--iters` chunks: ms per `score_batch`, and the
  weights' and the peak allocated memory;
- over one more chunk under `torch.profiler`: device time by kind of kernel
  (the hand-written kernels by name, dense GEMMs, cuDNN, everything else),
  and the profiled device time against the chunk's wall time (the rest is
  the device's idle share);
- the card's name and power limit beside every number.

Needs a CUDA card; there is no CPU mode.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

CTX, FRAMES, IMAGE, TEXT, BATCH = 7, 8, 448, 64, 4
MODES = ("bf16", "w8a8", "w8a8_fused", "int8", "int4")
KINDS = (  # (label, substrings of the kernel's name)
    ("decode_attention", ("decode_attention_partial", "decode_attention_combine")),
    ("attention_fwd", ("flash_fwd_kernel",)),
    ("weight_only_matmul", ("weight_only_matmul_kernel",)),
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


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--modes", nargs="+", choices=MODES, default=list(MODES))
    parser.add_argument("--iters", type=int, default=5)
    parser.add_argument("--config", help="a reference-format config.json (default: 2B)")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("profile_score: needs a CUDA card", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]

    from torch.profiler import ProfilerActivity, profile

    from aigv_assessor_torch.cli.score import build_serving_model, score_batch
    from aigv_assessor_torch.core.config import LLM_2B, AssessorConfig
    from aigv_assessor_torch.core.precision import COMPONENTS, Precision

    flags = {"bf16": {}, "w8a8_fused": dict(
        w8a8=True, precision=Precision(fuse_quant=COMPONENTS, quant_rows=COMPONENTS))}

    cfg = AssessorConfig.from_json(args.config) if args.config else AssessorConfig(llm=LLM_2B)
    cfg = cfg.replace(stage=2, img_context_token_id=CTX)
    rng = np.random.default_rng(0)
    n_ctx = FRAMES * cfg.num_image_token + 1
    ids = rng.integers(10, cfg.llm.vocab_size, (BATCH, 1, n_ctx + TEXT))
    ids[:, :, 1 : 1 + n_ctx] = CTX
    ids = torch.as_tensor(ids, device=device)
    mask = torch.ones(ids.shape, dtype=torch.bool, device=device)
    pixels = torch.as_tensor(
        rng.integers(0, 256, (BATCH, FRAMES, IMAGE, IMAGE, 3), dtype=np.uint8), device=device)

    for mode in args.modes:
        model = build_serving_model(cfg, device=device, seed=0, **flags.get(mode, {mode: True}))
        torch.cuda.synchronize()
        weights_gib = torch.cuda.memory_allocated(device) / 2**30 - (
            ids.numel() * 8 + mask.numel() + pixels.numel()) / 2**30
        score_batch(model, ids, pixels, mask)  # warm-up: cuDNN plans, the allocator
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(args.iters):
            score_batch(model, ids, pixels, mask)
        end.record()
        torch.cuda.synchronize()
        chunk_ms = start.elapsed_time(end) / args.iters
        peak_gib = torch.cuda.max_memory_allocated(device) / 2**30

        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            score_batch(model, ids, pixels, mask)
            torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        by_kind: dict = {}
        for evt in prof.key_averages():
            device_us = getattr(evt, "self_device_time_total", 0) or 0
            if device_us and evt.device_type.name != "CPU":
                k = kind_of(evt.key)
                by_kind[k] = by_kind.get(k, 0.0) + device_us / 1e3
        print(json.dumps({
            "mode": mode, "chunk_ms": round(chunk_ms, 3),
            "weights_gib": round(weights_gib, 3), "peak_gib": round(peak_gib, 3),
            "profiled_chunk": {k: round(v, 3)
                               for k, v in sorted(by_kind.items(), key=lambda kv: -kv[1])},
            "device_ms": round(sum(by_kind.values()), 3),
            "wall_ms_under_profiler": round(wall_ms, 3), "card": card,
        }), flush=True)
        del model
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
