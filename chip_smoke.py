#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`aigv_assessor_torch`) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing one line (and failing the run by raising):

1. device: a CUDA card is required; prints its name, and its name and power
   limit as nvidia-smi gives them.
2. build: compiles the flash-attention kernel from
   `aigv_assessor_torch/csrc/flash_attn_fwd.cu` for sm_90a.
3. kernel: the kernel against its plain PyTorch version on the same bf16
   inputs, at the ViT's and the LLM's shapes of the 2B model and at a small
   ragged shape with a +-1e3 garbage tail, to atol = rtol = 2e-2; and both
   timed with CUDA events after warm-up.
4. slice: stage-2 scoring of the InternVL2-2B model (full depth and width,
   random weights from a seed) through `cli/score.score_chunks`, two chunks
   of four synthetic 8-frame 448 px videos with the 2113-token prompt.
   Checks [4, 1] finite scores, 48 kernel launches per forward (24 ViT + 24
   LLM layers), and the len-4 readout hidden state of the kernel path
   against the same forward through the plain attention, and against an
   fp32 forward of the same weights (tolerances at READOUT_TOL).

Then one JSON line describing the kernel, and last
{"ok": true, "device": {...}}. Imports nothing of JAX.
"""

from __future__ import annotations

import copy
import json
import subprocess
import sys
import time
from unittest import mock

import numpy as np
import torch

TOL = 2e-2  # kernel vs plain, atol = rtol, bf16 outputs
# Readout hidden state (len - 4) after 48 bf16 layers. Two bf16 forwards that
# differ only in rounding order are ~2e-2 apart in relative L2 there: on an
# H100 the plain-attention bf16 path was 2.09e-2 from an fp32 forward of the
# same weights and 2.03e-2 from the kernel path, growing layer by layer like
# accumulated rounding. So the kernel path must (a) stay within 3e-2 of the
# plain path and (b) be no more than 1.25x as far from the fp32 forward as
# the plain bf16 path is.
READOUT_TOL = 3e-2
REF_RATIO = 1.25
CTX = 7  # <IMG_CONTEXT> id of the synthetic prompts
FRAMES, IMAGE, TEXT, BATCH, CHUNKS = 8, 448, 64, 4, 2
# (B, hq, hkv, S, D, causal, kv_valid)
SHAPES = {
    "vit": (32, 16, 16, 1032, 64, False, 1025),
    "llm": (4, 16, 8, 2113, 128, True, None),
    "ragged": (2, 4, 4, 200, 64, False, 150),
}


def phase(name: str, msg: str) -> None:
    print(f"[{name}] {msg}", flush=True)


def time_ms(fn, iters: int, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def check_kernel(fa, device) -> dict:
    results = {}
    for name, (b, hq, hkv, s, d, causal, kv_valid) in SHAPES.items():
        gen = torch.Generator(device=device).manual_seed(0)
        qkv = torch.randn((b, hq + 2 * hkv, s, d), generator=gen, device=device)
        if kv_valid is not None:
            qkv[:, hq : hq + hkv, kv_valid:] = 1e3
            qkv[:, hq + hkv :, kv_valid:] = -1e3
        qkv = qkv.to(torch.bfloat16)
        kw = dict(causal=causal, kv_valid=kv_valid)
        got = fa.flash_attention_qkv(qkv, hq, hkv, **kw)
        torch.cuda.synchronize()
        want = fa.plain_attention_qkv(qkv, hq, hkv, **kw)
        if not torch.isfinite(got).all():
            raise RuntimeError(f"kernel output at the {name} shape is not finite")
        err = (got.float() - want.float()).abs().max().item()
        torch.testing.assert_close(got.float(), want.float(), atol=TOL, rtol=TOL)
        ms = time_ms(lambda: fa.flash_attention_qkv(qkv, hq, hkv, **kw), 20)
        plain_ms = time_ms(lambda: fa.plain_attention_qkv(qkv, hq, hkv, **kw), 5)
        results[name] = dict(
            shape=f"B={b} hq={hq} hkv={hkv} S={s} D={d} causal={causal} kv_valid={kv_valid}",
            max_abs_err=err, ms=ms, plain_ms=plain_ms,
        )
        phase("kernel", f"{name}: {results[name]['shape']} max_abs_err={err:.3e} "
              f"(atol=rtol={TOL}) kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    return results


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; needs a CUDA card",
              file=sys.stderr)
        return 1
    # 1. device
    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    phase("device", f"{kind}, torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.device_count()} card(s)")
    print(smi, flush=True)

    from aigv_assessor_torch.cli.score import build_serving_model, score_batch, score_chunks
    from aigv_assessor_torch.core.config import LLM_2B, AssessorConfig
    from aigv_assessor_torch.core.precision import Precision
    from aigv_assessor_torch.ops import flash_attention as fa
    from aigv_assessor_torch.ops.preprocess import resize_normalize

    # 2. build, always from the checkout's source
    fa.LIBRARY.unlink(missing_ok=True)
    build_s = fa.build_kernel(verbose=True)
    phase("build", f"{fa.SOURCE.name} -> {fa.LIBRARY.name} for sm_90a in {build_s:.2f} s")

    # 3. kernel against the plain version
    shapes = check_kernel(fa, device)

    # 4. the scoring slice at 2B
    cfg = AssessorConfig(llm=LLM_2B, stage=2).replace(img_context_token_id=CTX)
    t0 = time.perf_counter()
    model = build_serving_model(cfg, device=device, seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    rng = np.random.default_rng(0)
    n_ctx = FRAMES * cfg.num_image_token + 1
    seq = n_ctx + TEXT
    ids_pn = rng.integers(10, cfg.llm.vocab_size, (1, seq))
    ids_pn[:, 1 : 1 + n_ctx] = CTX
    mask_pn = np.ones((1, seq), bool)
    videos = rng.integers(0, 256, (CHUNKS * BATCH, FRAMES, IMAGE, IMAGE, 3), dtype=np.uint8)
    chunks = [list(videos[i : i + BATCH]) for i in range(0, len(videos), BATCH)]

    ids = torch.as_tensor(np.tile(ids_pn[None], (BATCH, 1, 1)), device=device)
    mask = torch.as_tensor(np.tile(mask_pn[None], (BATCH, 1, 1)), device=device)
    px_u8 = torch.as_tensor(videos[:BATCH], device=device)
    scores = score_batch(model, ids, px_u8, mask)  # warm-up: cuDNN plans, allocator
    torch.cuda.synchronize()
    if tuple(scores.shape) != (BATCH, 1) or not torch.isfinite(scores).all():
        raise RuntimeError(f"scores {tuple(scores.shape)} not finite [{BATCH}, 1]: {scores}")

    torch.cuda.reset_peak_memory_stats(device)
    fa.flash_attention_qkv.launches = 0
    t0 = time.perf_counter()
    rows = score_chunks(model, chunks, ids_pn, mask_pn, batch_size=BATCH)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = fa.flash_attention_qkv.launches
    peak_gib = torch.cuda.max_memory_allocated(device) / 2**30
    n_vit, n_llm = cfg.vision.num_hidden_layers, cfg.llm.num_hidden_layers
    per_forward = n_vit + n_llm
    if launches != per_forward * CHUNKS:
        raise RuntimeError(f"{launches} kernel launches for {CHUNKS} forwards, "
                           f"expected {per_forward} each")
    arr = np.asarray(rows)
    if arr.shape != (CHUNKS * BATCH, 1) or not np.isfinite(arr).all():
        raise RuntimeError(f"score rows {arr.shape} not finite [{CHUNKS * BATCH}, 1]")

    # the same weights in fp32 with the plain attention: the reference both
    # bf16 paths are measured against
    ref = copy.deepcopy(model).float()
    ref.precision = Precision.fp32()
    with torch.inference_mode():
        pv = resize_normalize(px_u8, size=IMAGE, dtype=torch.float32)
        kernel_out = model(ids[:, 0], pv.to(model.precision.compute_dtype), mask[:, 0])
        with mock.patch.object(fa, "flash_attention_qkv", fa.plain_attention_qkv):
            plain_out = model(ids[:, 0], pv.to(model.precision.compute_dtype), mask[:, 0])
            ref_out = ref(ids[:, 0], pv, mask[:, 0])
    del ref
    k, p, r = (o["readout"].float() for o in (kernel_out, plain_out, ref_out))
    rel_kp, rel_kr, rel_pr = (
        ((x - y).norm() / y.norm()).item() for x, y in ((k, p), (k, r), (p, r))
    )
    if not torch.isfinite(k).all() or not rel_kp <= READOUT_TOL:
        raise RuntimeError(f"readout relative L2 kernel vs plain {rel_kp} above {READOUT_TOL}")
    if not rel_kr <= REF_RATIO * rel_pr:
        raise RuntimeError(f"kernel path {rel_kr} from the fp32 reference, plain bf16 "
                           f"path {rel_pr}: more than {REF_RATIO}x farther")
    phase("slice", f"InternVL2-2B stage-2 scoring, {CHUNKS} chunks x {BATCH} videos x "
          f"{FRAMES} frames {IMAGE}px, seq {seq}: {launches} kernel launches "
          f"({per_forward}/forward), {elapsed / CHUNKS * 1e3:.1f} ms/chunk, peak "
          f"{peak_gib:.2f} GiB allocated, init {init_s:.1f} s; readout rel L2 kernel vs "
          f"plain {rel_kp:.3e} (tol {READOUT_TOL}), vs fp32 reference: kernel "
          f"{rel_kr:.3e}, plain {rel_pr:.3e} (tol {REF_RATIO}x); scores "
          f"{np.round(arr[:, 0], 4).tolist()} [{smi}]")

    print(json.dumps({"kernels": [{
        "name": "flash_attn_qkv_fwd",
        "route": "cuda",
        "source": "aigv_assessor_torch/csrc/flash_attn_fwd.cu",
        "replaces": "aigv_assessor_tpu/ops/pallas_attention.py:106",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in shapes.values()),
        # one forward's attention: one launch per layer at each tower's shape
        "ms": n_vit * shapes["vit"]["ms"] + n_llm * shapes["llm"]["ms"],
        "plain_ms": n_vit * shapes["vit"]["plain_ms"] + n_llm * shapes["llm"]["plain_ms"],
        "shapes": shapes,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
