#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`aigv_assessor_torch`) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing one line or more (and failing the run by raising):

1. device: a CUDA card is required; prints its name, and its name and power
   limit as nvidia-smi gives them.
2. build: compiles the port's CUDA sources for sm_90a, one nvcc per source,
   all started together: the flash-attention kernel
   (`aigv_assessor_torch/csrc/flash_attn_fwd.cu`) and the fused quantize
   kernels (`csrc/quant_fuse.cu`).
3. kernel: each kernel against its plain PyTorch version on the same inputs,
   both timed with CUDA events after warm-up.
   - The flash-attention kernel in both output layouts, at the ViT's and the
     LLM's shapes of the 2B model and at a small ragged shape with a +-1e3
     garbage tail, to atol = rtol = 2e-2. Its dense `bsd` output must equal
     its head-major `bhsd` output transposed, bit for bit.
   - The LayerNorm / tanh-GELU / identity + int8 quantize kernels at the 2B
     ViT's feed shapes and at a ragged row count: scales within rtol 1e-5,
     int8 values differing by at most one on at most 1e-3 of the elements.
4. slice (bf16): stage-2 scoring of the InternVL2-2B model (full depth and
   width, random weights from a seed) through `cli/score.score_chunks`, two
   chunks of four synthetic 8-frame 448 px videos with the 2113-token
   prompt. Checks [4, 1] finite scores, 48 attention launches per forward
   (24 ViT + 24 LLM layers), and the len-4 readout hidden state of the
   kernel path against the same forward through the plain attention, and
   against an fp32 forward of the same weights (tolerances at READOUT_TOL).
5. slice (W8A8): the same weights, seed and videos served W8A8
   (`build_serving_model(w8a8=True)`). Checks finite [4, 1] scores, per
   forward 48 attention launches (dense `bsd` output), 48 LayerNorm-quantize,
   24 GELU-quantize and 24 identity-quantize launches; the readout of the
   kernel path against the same W8A8 forward with every kernel swapped for
   its plain version, and against a W8A8 forward of the same int8 weights
   with fp32 activations (tolerances at W8A8_READOUT_TOL); and the W8A8
   readout's cosine to the bf16 readout at least W8A8_COSINE.

Then one JSON line describing the kernels, and last
{"ok": true, "device": {...}}. Imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import copy
import json
import subprocess
import sys
import time
from unittest import mock

import numpy as np
import torch

TOL = 2e-2  # attention kernel vs plain, atol = rtol, bf16 outputs
# Readout hidden state (len - 4) after 48 bf16 layers. Two bf16 forwards that
# differ only in rounding order are ~2e-2 apart in relative L2 there: on an
# H100 the plain-attention bf16 path was 2.09e-2 from an fp32 forward of the
# same weights and 2.03e-2 from the kernel path, growing layer by layer like
# accumulated rounding. So the kernel path must (a) stay within 3e-2 of the
# plain path and (b) be no more than 1.25x as far from the fp32 forward as
# the plain bf16 path is.
READOUT_TOL = 3e-2
REF_RATIO = 1.25
# Under W8A8 a rounding difference anywhere flips int8 values, and a flip
# moves a value by a whole quantization step, so any two W8A8 forwards that
# differ only in rounding order land ~7e-2 apart at the readout: on an H100
# the kernel path was 7.10e-2 from the plain path, and each was 7.06e-2 and
# 6.75e-2 from a W8A8 forward of the same weights with fp32 activations.
# So the kernel path must (a) stay within 1e-1 of the plain path and (b) be
# no more than REF_RATIO as far from the fp32-activation W8A8 forward as the
# plain path is.
W8A8_READOUT_TOL = 1e-1
# W8A8 against bf16 of the same weights: the JAX package's own bound
# (tests/test_w8a8.py, hidden-state cosine > 0.99)
W8A8_COSINE = 0.99
# quantize kernels vs plain: the row sums run in another order and tanh and
# rsqrt come from other library code, so y / s may land on the other side of
# a half
SCALE_RTOL = 1e-5
FLIP_FRACTION = 1e-3
CTX = 7  # <IMG_CONTEXT> id of the synthetic prompts
FRAMES, IMAGE, TEXT, BATCH, CHUNKS = 8, 448, 64, 4, 2
# (B, hq, hkv, S, D, causal, kv_valid)
SHAPES = {
    "vit": (32, 16, 16, 1032, 64, False, 1025),
    "llm": (4, 16, 8, 2113, 128, True, None),
    "ragged": (2, 4, 4, 200, 64, False, 150),
}
# quantize feeds of the 2B ViT (32 frames x 1032 tokens): (rows, cols,
# launches per forward, TPU kernel body replaced)
FEEDS = {
    "ln_quant": (33024, 1024, 48, "aigv_assessor_tpu/ops/quant_fuse.py:120"),
    "gelu_quant": (33024, 4096, 24, "aigv_assessor_tpu/ops/quant_fuse.py:132"),
    "ident_quant": (33024, 1024, 24, "aigv_assessor_tpu/ops/quant_fuse.py:140"),
}
RAGGED_ROWS = 1000


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


def check_attention(fa, device) -> dict:
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
        dense = fa.flash_attention_qkv(qkv, hq, hkv, out_layout="bsd", **kw)
        torch.cuda.synchronize()
        want = fa.plain_attention_qkv(qkv, hq, hkv, **kw)
        want_dense = fa.plain_attention_qkv(qkv, hq, hkv, out_layout="bsd", **kw)
        if not torch.isfinite(got).all():
            raise RuntimeError(f"kernel output at the {name} shape is not finite")
        err = (got.float() - want.float()).abs().max().item()
        torch.testing.assert_close(got.float(), want.float(), atol=TOL, rtol=TOL)
        # bsd differs from bhsd only in the store addresses: equal bit for bit
        if dense.shape != (b, s, hq * d) or not torch.equal(
            dense, got.transpose(1, 2).reshape(b, s, hq * d)
        ):
            raise RuntimeError(f"bsd output at the {name} shape is not bhsd transposed")
        err_dense = (dense.float() - want_dense.float()).abs().max().item()
        torch.testing.assert_close(dense.float(), want_dense.float(), atol=TOL, rtol=TOL)
        ms = time_ms(lambda: fa.flash_attention_qkv(qkv, hq, hkv, **kw), 20)
        plain_ms = time_ms(lambda: fa.plain_attention_qkv(qkv, hq, hkv, **kw), 5)
        bsd = dict(out_layout="bsd", **kw)
        ms_dense = time_ms(lambda: fa.flash_attention_qkv(qkv, hq, hkv, **bsd), 20)
        plain_ms_dense = time_ms(lambda: fa.plain_attention_qkv(qkv, hq, hkv, **bsd), 5)
        shape = f"B={b} hq={hq} hkv={hkv} S={s} D={d} causal={causal} kv_valid={kv_valid}"
        results[name] = dict(
            shape=shape, max_abs_err=err, ms=ms, plain_ms=plain_ms,
            bsd_max_abs_err=err_dense, bsd_ms=ms_dense, bsd_plain_ms=plain_ms_dense,
        )
        phase("kernel", f"attention {name}: {shape} max_abs_err bhsd {err:.3e} bsd "
              f"{err_dense:.3e} (atol=rtol={TOL}), bsd == bhsd transposed exactly; "
              f"bhsd kernel {ms:.4f} ms, plain {plain_ms:.4f} ms; bsd kernel "
              f"{ms_dense:.4f} ms, plain {plain_ms_dense:.4f} ms")
    return results


def feed_inputs(name: str, rows: int, cols: int, device) -> tuple:
    gen = torch.Generator(device=device).manual_seed(1)
    x = (2.0 * torch.randn((rows, cols), generator=gen, device=device)).to(torch.bfloat16)
    if name != "ln_quant":
        return (x,)
    w = (1.0 + 0.2 * torch.randn(cols, generator=gen, device=device)).to(torch.bfloat16)
    b = (0.1 * torch.randn(cols, generator=gen, device=device)).to(torch.bfloat16)
    return x, w, b


def check_feeds(qf, device) -> dict:
    calls = {
        "ln_quant": (qf.layernorm_quant, qf.plain_layernorm_quant),
        "gelu_quant": (qf.gelu_quant, qf.plain_gelu_quant),
        "ident_quant": (qf.quant_rows, qf.plain_quant_rows),
    }
    results = {}
    for name, (rows, cols, _, _) in FEEDS.items():
        kernel, plain = calls[name]
        stats = {}
        for label, n in (("path", rows), ("ragged", RAGGED_ROWS)):
            args = feed_inputs(name, n, cols, device)
            q, s = kernel(*args)
            torch.cuda.synchronize()
            q2, s2 = plain(*args)
            if q.dtype != torch.int8 or q.shape != (n, cols) or s.shape != (n, 1):
                raise RuntimeError(f"{name}: outputs {q.dtype} {tuple(q.shape)} {tuple(s.shape)}")
            scale_err = ((s - s2).abs() / s2.abs()).max().item()
            diff = (q.int() - q2.int()).abs()
            flips = (diff > 0).float().mean().item()
            if not (scale_err <= SCALE_RTOL and diff.max().item() <= 1
                    and flips <= FLIP_FRACTION):
                raise RuntimeError(
                    f"{name} at {n}x{cols}: scale rel err {scale_err:.3e} (tol "
                    f"{SCALE_RTOL}), int8 max diff {diff.max().item()}, flipped "
                    f"share {flips:.3e} (tol {FLIP_FRACTION})")
            deq_err = (q.float() * s - q2.float() * s2).abs().max().item()
            stats[label] = dict(rows=n, scale_rel_err=scale_err, flipped_share=flips,
                                dequant_max_abs_err=deq_err)
        args = feed_inputs(name, rows, cols, device)
        ms = time_ms(lambda: kernel(*args), 20)
        plain_ms = time_ms(lambda: plain(*args), 5)
        p, r = stats["path"], stats["ragged"]
        results[name] = dict(
            cols=cols, ms=ms, plain_ms=plain_ms, path=p, ragged=r,
            max_abs_err=max(p["dequant_max_abs_err"], r["dequant_max_abs_err"]),
        )
        phase("kernel", f"{name}: {rows}x{cols} and {RAGGED_ROWS}x{cols} bf16: scale rel "
              f"err {p['scale_rel_err']:.3e} / {r['scale_rel_err']:.3e} (tol {SCALE_RTOL}), "
              f"int8 flipped share {p['flipped_share']:.3e} / {r['flipped_share']:.3e} "
              f"(tol {FLIP_FRACTION}, each by one); kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms at {rows}x{cols}")
    return results


def relative_l2(x: torch.Tensor, y: torch.Tensor) -> float:
    return ((x - y).norm() / y.norm()).item()


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
    from aigv_assessor_torch.models.assessor import AIGVAssessor
    from aigv_assessor_torch.ops import cuda_build
    from aigv_assessor_torch.ops import flash_attention as fa
    from aigv_assessor_torch.ops import quant_fuse as qf
    from aigv_assessor_torch.ops.preprocess import resize_normalize

    # 2. build, always from the checkout's sources
    libs = (fa.LIB, qf.LIB)
    for lib in libs:
        lib.path.unlink(missing_ok=True)
    build_s = cuda_build.build(libs, verbose=True)
    phase("build", f"{', '.join(lib.source.name for lib in libs)} -> "
          f"{', '.join(lib.path.name for lib in libs)} for sm_90a in {build_s:.2f} s")

    # 3. kernels against their plain versions
    shapes = check_attention(fa, device)
    feeds = check_feeds(qf, device)

    # 4. the bf16 scoring slice at 2B
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
    n_vit, n_llm = cfg.vision.num_hidden_layers, cfg.llm.num_hidden_layers
    per_forward = n_vit + n_llm

    def run_slice(model, label: str):
        """Warm-up, then the main path's run with every count set to 0 just
        before it. -> (counts, ms per chunk, peak GiB, weights GiB)."""
        weights_gib = torch.cuda.memory_allocated(device) / 2**30
        scores = score_batch(model, ids, px_u8, mask)  # warm-up: cuDNN plans, allocator
        torch.cuda.synchronize()
        if tuple(scores.shape) != (BATCH, 1) or not torch.isfinite(scores).all():
            raise RuntimeError(f"{label}: scores {tuple(scores.shape)} not finite "
                               f"[{BATCH}, 1]: {scores}")
        torch.cuda.reset_peak_memory_stats(device)
        counters = (fa.flash_attention_qkv, qf.layernorm_quant, qf.gelu_quant, qf.quant_rows)
        for c in counters:
            c.launches = 0
        t0 = time.perf_counter()
        rows = score_chunks(model, chunks, ids_pn, mask_pn, batch_size=BATCH)
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        counts = {c.__name__: c.launches for c in counters}
        peak_gib = torch.cuda.max_memory_allocated(device) / 2**30
        arr = np.asarray(rows)
        if arr.shape != (CHUNKS * BATCH, 1) or not np.isfinite(arr).all():
            raise RuntimeError(f"{label}: score rows {arr.shape} not finite "
                               f"[{CHUNKS * BATCH}, 1]")
        return counts, elapsed / CHUNKS * 1e3, peak_gib, weights_gib, arr

    counts, ms_bf16, peak_bf16, weights_bf16, arr = run_slice(model, "bf16")
    want = {"flash_attention_qkv": per_forward * CHUNKS, "layernorm_quant": 0,
            "gelu_quant": 0, "quant_rows": 0}
    if counts != want:
        raise RuntimeError(f"bf16: launches {counts} for {CHUNKS} forwards, expected {want}")
    launches_bhsd = counts["flash_attention_qkv"]

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
    rel_kp, rel_kr, rel_pr = relative_l2(k, p), relative_l2(k, r), relative_l2(p, r)
    if not torch.isfinite(k).all() or not rel_kp <= READOUT_TOL:
        raise RuntimeError(f"readout relative L2 kernel vs plain {rel_kp} above {READOUT_TOL}")
    if not rel_kr <= REF_RATIO * rel_pr:
        raise RuntimeError(f"kernel path {rel_kr} from the fp32 reference, plain bf16 "
                           f"path {rel_pr}: more than {REF_RATIO}x farther")
    phase("slice", f"bf16 InternVL2-2B stage-2 scoring, {CHUNKS} chunks x {BATCH} videos x "
          f"{FRAMES} frames {IMAGE}px, seq {seq}: {launches_bhsd} attention launches "
          f"({per_forward}/forward), {ms_bf16:.1f} ms/chunk, peak {peak_bf16:.2f} GiB "
          f"allocated ({weights_bf16:.2f} GiB weights), init {init_s:.1f} s; readout rel L2 "
          f"kernel vs plain {rel_kp:.3e} (tol {READOUT_TOL}), vs fp32 reference: kernel "
          f"{rel_kr:.3e}, plain {rel_pr:.3e} (tol {REF_RATIO}x); scores "
          f"{np.round(arr[:, 0], 4).tolist()} [{smi}]")
    readout_bf16 = k
    del model, kernel_out, plain_out, ref_out, pv
    torch.cuda.empty_cache()

    # 5. the W8A8 scoring slice: same seed, same videos
    t0 = time.perf_counter()
    model = build_serving_model(cfg, device=device, seed=0, w8a8=True)
    torch.cuda.synchronize()
    init8_s = time.perf_counter() - t0
    counts8, ms_w8a8, peak_w8a8, weights_w8a8, arr8 = run_slice(model, "W8A8")
    want = {"flash_attention_qkv": per_forward * CHUNKS,
            "layernorm_quant": FEEDS["ln_quant"][2] * CHUNKS,
            "gelu_quant": FEEDS["gelu_quant"][2] * CHUNKS,
            "quant_rows": FEEDS["ident_quant"][2] * CHUNKS}
    if counts8 != want:
        raise RuntimeError(f"W8A8: launches {counts8} for {CHUNKS} forwards, expected {want}")

    plain_swaps = ((fa, "flash_attention_qkv", fa.plain_attention_qkv),
                   (qf, "layernorm_quant", qf.plain_layernorm_quant),
                   (qf, "gelu_quant", qf.plain_gelu_quant),
                   (qf, "quant_rows", qf.plain_quant_rows))
    # the same int8 weights and scales with fp32 activations and the plain
    # versions (the kernels take bf16): the reference both W8A8 paths are
    # measured against
    with torch.device("meta"):
        ref = AIGVAssessor(cfg, Precision(compute_dtype=torch.float32, w8a8=True))
    ref.load_state_dict({k: v.float() if v.is_floating_point() else v
                         for k, v in model.state_dict().items()}, strict=True, assign=True)
    with torch.inference_mode():
        pv = resize_normalize(px_u8, size=IMAGE, dtype=torch.float32)
        # the bf16 phase's input, made the same way
        kernel_out = model(ids[:, 0], pv.to(model.precision.compute_dtype), mask[:, 0])
        launched = [getattr(m, n).launches for m, n, _ in plain_swaps]
        with contextlib.ExitStack() as stack:
            for module, name, plain in plain_swaps:
                stack.enter_context(mock.patch.object(module, name, plain))
            plain_out = model(ids[:, 0], pv.to(model.precision.compute_dtype), mask[:, 0])
            ref_out = ref.eval()(ids[:, 0], pv, mask[:, 0])
        if [getattr(m, n).launches for m, n, _ in plain_swaps] != launched:
            raise RuntimeError("the plain W8A8 forwards launched a kernel")
    del ref
    k8, p8, r8 = (o["readout"].float() for o in (kernel_out, plain_out, ref_out))
    rel8, rel8_kr, rel8_pr = relative_l2(k8, p8), relative_l2(k8, r8), relative_l2(p8, r8)
    if not torch.isfinite(k8).all() or not rel8 <= W8A8_READOUT_TOL:
        raise RuntimeError(f"W8A8 readout relative L2 kernel vs plain {rel8} above "
                           f"{W8A8_READOUT_TOL}")
    if not rel8_kr <= REF_RATIO * rel8_pr:
        raise RuntimeError(f"W8A8 kernel path {rel8_kr} from the fp32-activation reference, "
                           f"plain path {rel8_pr}: more than {REF_RATIO}x farther")
    a, bf = k8.flatten(), readout_bf16.flatten()
    cosine = (a @ bf / (a.norm() * bf.norm())).item()
    if not cosine >= W8A8_COSINE:
        raise RuntimeError(f"W8A8 readout cosine to bf16 {cosine} below {W8A8_COSINE}")
    phase("slice", f"W8A8 InternVL2-2B stage-2 scoring, same seed and videos: launches "
          f"{counts8} ({per_forward} attention, {FEEDS['ln_quant'][2]} ln_quant, "
          f"{FEEDS['gelu_quant'][2]} gelu_quant, {FEEDS['ident_quant'][2]} ident_quant per "
          f"forward), {ms_w8a8:.1f} ms/chunk (bf16 {ms_bf16:.1f}), peak {peak_w8a8:.2f} GiB "
          f"allocated (bf16 {peak_bf16:.2f}), weights {weights_w8a8:.2f} GiB (bf16 "
          f"{weights_bf16:.2f}), init {init8_s:.1f} s; readout rel L2 kernel vs plain "
          f"{rel8:.3e} (tol {W8A8_READOUT_TOL}), vs fp32-activation W8A8 reference: kernel "
          f"{rel8_kr:.3e}, plain {rel8_pr:.3e} (tol {REF_RATIO}x), cosine to bf16 "
          f"{cosine:.5f} (tol {W8A8_COSINE}); "
          f"scores {np.round(arr8[:, 0], 4).tolist()} [{smi}]")

    attention = dict(route="cuda", source="aigv_assessor_torch/csrc/flash_attn_fwd.cu",
                     replaces="aigv_assessor_tpu/ops/pallas_attention.py:106")
    # ms and plain_ms: one forward's launches at the path's shapes
    kernels = [
        dict(name="flash_attn_qkv_fwd", **attention, launches=launches_bhsd,
             max_abs_err=max(r["max_abs_err"] for r in shapes.values()),
             ms=n_vit * shapes["vit"]["ms"] + n_llm * shapes["llm"]["ms"],
             plain_ms=n_vit * shapes["vit"]["plain_ms"] + n_llm * shapes["llm"]["plain_ms"],
             shapes=shapes),
        dict(name="flash_attn_qkv_fwd_bsd", **attention,
             launches=counts8["flash_attention_qkv"],
             max_abs_err=max(r["bsd_max_abs_err"] for r in shapes.values()),
             ms=n_vit * shapes["vit"]["bsd_ms"] + n_llm * shapes["llm"]["bsd_ms"],
             plain_ms=n_vit * shapes["vit"]["bsd_plain_ms"]
             + n_llm * shapes["llm"]["bsd_plain_ms"]),
    ]
    for name, counter in (("ln_quant", "layernorm_quant"), ("gelu_quant", "gelu_quant"),
                          ("ident_quant", "quant_rows")):
        rows, cols, per_fwd, replaces = FEEDS[name]
        f = feeds[name]
        kernels.append(dict(
            name=name, route="cuda", source="aigv_assessor_torch/csrc/quant_fuse.cu",
            replaces=replaces, launches=counts8[counter], max_abs_err=f["max_abs_err"],
            ms=per_fwd * f["ms"], plain_ms=per_fwd * f["plain_ms"], detail=f))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
