"""Where generation and shared-prefix scoring spend their time on the card.

    python -m aigv_assessor_torch.tools.profile_generate [--modes bf16 int8 kv_int8]

For each mode it builds the InternVL2-2B serving model from a seed
(`cli/score.build_serving_model`; `kv_int8` is bf16 weights with the int8 KV
cache) and runs the shapes `chip_smoke.py` generates at: 4 videos x 8 frames
x 448 px, a 2113-token prompt with the motion embedding, a cache of 2113 +
`--tokens` rows. It prints, as JSON lines:

- the prefill (`AIGVAssessor.prefill` of the embedded prompt): ms by CUDA
  events, and under `torch.profiler` its device time by kind of kernel;
- the decode loop (`models/generation.decode_loop`, greedy, never stopping):
  host ms per step with the device drained at the end, and over `--steps`
  profiled `decode_step`s the device time per step by kind of kernel, the
  kernels launched per step, and the device time against the wall time (the
  rest is the device's idle share);
- in the bf16 mode, one chunk of `score_batch` with 4 prompts that share
  their first 2081 tokens, with and without `shared_prefix_len`: ms by CUDA
  events and device time by kind;
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

from aigv_assessor_torch.tools.profile_score import kind_of

CTX, FRAMES, IMAGE, TEXT, BATCH = 7, 8, 448, 64, 4
PERSPECTIVES, SUFFIX = 4, 32
MODES = ("bf16", "w8a8", "int8", "int4", "kv_int8")


def profiled(fn) -> dict:
    """Run `fn` under the profiler -> device ms by kind, kernels launched,
    device ms in all and wall ms."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    by_kind: dict = {}
    launches = 0
    for evt in prof.key_averages():
        device_us = getattr(evt, "self_device_time_total", 0) or 0
        if device_us and evt.device_type.name != "CPU":
            k = kind_of(evt.key)
            by_kind[k] = by_kind.get(k, 0.0) + device_us / 1e3
            launches += evt.count
    return {"by_kind_ms": by_kind, "kernels": launches, "device_ms": sum(by_kind.values()),
            "wall_ms": wall_ms}


def events_ms(fn, iters: int) -> float:
    fn()  # warm-up
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def rounded(d: dict, scale: float = 1.0) -> dict:
    return {k: round(v / scale, 4) for k, v in sorted(d.items(), key=lambda kv: -kv[1])}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--modes", nargs="+", choices=MODES, default=["bf16", "int8", "kv_int8"])
    parser.add_argument("--tokens", type=int, default=32, help="new tokens of the decode loop")
    parser.add_argument("--steps", type=int, default=8, help="decode steps under the profiler")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("profile_generate: needs a CUDA card", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]

    from aigv_assessor_torch.cli.score import build_serving_model, score_batch
    from aigv_assessor_torch.core.config import LLM_2B, AssessorConfig
    from aigv_assessor_torch.models.generation import GenerationConfig, decode_loop
    from aigv_assessor_torch.models.internlm2 import KVCache
    from aigv_assessor_torch.ops.preprocess import resize_normalize

    cfg = AssessorConfig(llm=LLM_2B, stage=2).replace(img_context_token_id=CTX)
    rng = np.random.default_rng(0)
    n_ctx = FRAMES * cfg.num_image_token + 1
    seq = n_ctx + TEXT
    ids_np = rng.integers(10, cfg.llm.vocab_size, (BATCH, seq))
    ids_np[:, 1 : 1 + n_ctx] = CTX
    ids = torch.as_tensor(ids_np, device=device)
    pixels = torch.as_tensor(
        rng.integers(0, 256, (BATCH, FRAMES, IMAGE, IMAGE, 3), dtype=np.uint8), device=device)
    max_len = seq + args.tokens
    gcfg = GenerationConfig(max_new_tokens=args.tokens, eos_token_id=-1)
    kv_mask = torch.ones((BATCH, max_len), dtype=torch.bool, device=device)
    start_pos = torch.full((BATCH,), seq, dtype=torch.int64, device=device)
    first = torch.zeros(BATCH, dtype=torch.int64, device=device)

    for mode in args.modes:
        model = build_serving_model(cfg, device=device, seed=0,
                                    **({} if mode == "bf16" else {mode: True}))

        def new_cache():
            return KVCache.init(cfg.llm, BATCH, max_len, quantized=model.precision.kv_int8,
                                device=device)

        with torch.inference_mode():
            pv = resize_normalize(pixels, size=IMAGE, dtype=model.precision.compute_dtype)
            embeds = model.embed_multimodal(ids, pv, with_motion=True)
            torch.cuda.reset_peak_memory_stats(device)
            prefill_ms = events_ms(lambda: model.prefill(embeds, new_cache()), 2)
            peak_gib = torch.cuda.max_memory_allocated(device) / 2**30
            prefill = profiled(lambda: model.prefill(embeds, new_cache()))

            _, _, cache = model.prefill(embeds, new_cache())
            decode_loop(model, first, cache, start_pos, kv_mask, gcfg)  # warm-up
            _, _, cache = model.prefill(embeds, new_cache())
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            decode_loop(model, first, cache, start_pos, kv_mask, gcfg)
            torch.cuda.synchronize()
            step_ms = (time.perf_counter() - t0) * 1e3 / (args.tokens - 1)

            _, _, cache = model.prefill(embeds, new_cache())
            state = {"cache": cache}

            def steps():
                for i in range(args.steps):
                    _, _, state["cache"] = model.decode_step(
                        first[:, None], state["cache"], kv_mask,
                        position_ids=(start_pos + i)[:, None])

            decode = profiled(steps)
        print(json.dumps({
            "mode": mode, "prefill_ms": round(prefill_ms, 3), "prefill_peak_gib": round(peak_gib, 3),
            "prefill_by_kind_ms": rounded(prefill["by_kind_ms"]),
            "prefill_device_ms": round(prefill["device_ms"], 3),
            "decode_step_ms": round(step_ms, 3),
            "tokens_per_s": round(BATCH * 1e3 / step_ms, 1),
            "profiled_step_by_kind_ms": rounded(decode["by_kind_ms"], args.steps),
            "profiled_step_device_ms": round(decode["device_ms"] / args.steps, 4),
            "profiled_step_wall_ms": round(decode["wall_ms"] / args.steps, 3),
            "kernels_per_step": decode["kernels"] / args.steps, "card": card,
        }), flush=True)

        if mode == "bf16":
            prefix = seq - SUFFIX
            ids_p = rng.integers(10, cfg.llm.vocab_size, (PERSPECTIVES, seq))
            ids_p[:, :prefix] = ids_p[0, :prefix]
            ids_p[:, 1 : 1 + n_ctx] = CTX
            ids_bp = torch.as_tensor(np.tile(ids_p[None], (BATCH, 1, 1)), device=device)
            mask_bp = torch.ones(ids_bp.shape, dtype=torch.bool, device=device)
            for shared in (prefix, None):
                ms = events_ms(lambda: score_batch(model, ids_bp, pixels, mask_bp, shared), 3)
                torch.cuda.reset_peak_memory_stats(device)
                prof = profiled(lambda: score_batch(model, ids_bp, pixels, mask_bp, shared))
                print(json.dumps({
                    "mode": "bf16", "perspectives": PERSPECTIVES, "shared_prefix_len": shared,
                    "chunk_ms": round(ms, 3),
                    "peak_gib": round(torch.cuda.max_memory_allocated(device) / 2**30, 3),
                    "by_kind_ms": rounded(prof["by_kind_ms"]),
                    "device_ms": round(prof["device_ms"], 3), "card": card,
                }), flush=True)
        del model
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
