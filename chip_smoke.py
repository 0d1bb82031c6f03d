#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`aigv_assessor_torch`) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing one line or more (and failing the run by raising):

1. device: a CUDA card is required; prints its name, and its name and power
   limit as nvidia-smi gives them.
2. build: compiles the port's CUDA sources for sm_90a, one nvcc per source,
   all started together: the flash-attention forward
   (`aigv_assessor_torch/csrc/flash_attn_fwd.cu`), its backward
   (`csrc/flash_attn_bwd.cu`), the fused quantize kernels
   (`csrc/quant_fuse.cu`), the weight-only matmuls
   (`csrc/weight_only_matmul.cu`) and the decode attention
   (`csrc/decode_attention.cu`).
3. kernel: each kernel against its plain PyTorch version on the same inputs,
   both timed with CUDA events after warm-up, beside its bound (the larger of
   bytes / 3.35 TB/s and operations / 989 TFLOP/s, from this run's shapes)
   and, for attention, `F.scaled_dot_product_attention` on the same q/k/v
   views (GQA through `enable_gqa=True`, `kv_valid` by slicing k and v) as
   the library yardstick, which nothing in the port calls.
   - The flash-attention kernel in both output layouts, at the ViT's and the
     LLM's shapes of the 2B model and at a small ragged shape with a +-1e3
     garbage tail, to atol = rtol = 2e-2. Its dense `bsd` output must equal
     its head-major `bhsd` output transposed, bit for bit.
   - The forward with logsumexp and the two backward kernels (dq, dk/dv) at
     the same three shapes: `out` bit-equal to the forward without
     logsumexp; the logsumexp within LSE_TOL of the plain fp32 one; dq, dk
     and dv each within BWD_TOL relative L2 of `plain_attention_qkv_bwd` on
     the same (qkv, out, lse, dout), which rounds p and ds to bf16 where the
     kernels do; dk/dv rows of the keys at or beyond kv_valid exactly 0.
   - The LayerNorm / tanh-GELU / identity + int8 quantize kernels (device
     time by CUDA graph replay, and call by call with the host) at the 2B
     ViT's feed shapes, and the RMSNorm / SwiGLU + int8 kernels at the 2B
     decoder's (K5b also at the 8B decoder's 14336-wide feed), each also at a
     ragged row count: scales within rtol 1e-5, int8 values differing by at
     most one on at most 1e-3 of the elements.
   - The forward on three separate tensors at the LLM's shape (`bshd` views
     of one row-major projection output, causal, GQA), at the ViT's shape in
     both layouts with kv_valid 1025 of 1032, at a non-causal Sq != Skv shape
     and at the ragged shape, to the same atol = rtol = 2e-2; and against the
     fused-qkv kernel on the same data, with which it shares its body:
     bit-equal. Yardstick: SDPA on the same views.
   - K2's training forms on three tensors (the forward with logsumexp, the
     dq and the dk/dv kernel) at InternViT-6B's shape (B = 32 frames of a
     scoring chunk, and the frames of one 26B training micro-batch; 25
     heads, S = 1032 with kv_valid 1025, D = 128, `bshd`, q and k from the
     norms, v a strided view of the projection), at the 2B decoder's
     row-major shape (B = 4, 16 / 8 heads, S = 2113, causal, `bshd` views)
     and at a ragged non-causal Sq != Skv shape (`bhsd`, GQA, garbage tail):
     `out` bit-equal to the forward without logsumexp, the logsumexp within
     LSE_TOL, dq, dk and dv within BWD_TOL relative L2 of
     `plain_flash_attention_bwd`, dk / dv of masked keys exactly 0. Timed by
     CUDA graph replay beside the bound, the plain versions, SDPA's forward
     and SDPA's forward + backward.
   - The weight-only int8 and int4 matmuls at the decoder's projection
     shapes with M = 8452 rows (4 videos x 2113 tokens), at the decode sizes
     M = 4 and M = 1 of the same shapes (timed over enough copies of the
     weight that none is found in the L2 cache), at the LM head
     (2048 -> 92553) with M = 4, and for int4 at an odd K: relative L2 at most
     WO_TOL from the plain version, which multiplies the same bf16 inputs in
     fp32; against that version rounded to bf16, all but WO_UNEQUAL_SHARE of
     the elements equal and all but WO_ULP_SHARE within one bf16 ulp; and
     exactly 0 for an all-zero weight column. Yardstick, which
     nothing in the port calls: `F.linear` in bf16 on a weight dequantized
     beforehand, the same product with two or four times the weight bytes.
   - The decode-attention kernel at the decode step's shape (B = 4, 16 / 8
     heads, D = 128, a cache of 2177 rows; `end` = 2113 with full windows and
     2150 with ragged `starts`), with `end` = 0, with windows of one row and
     at D = 64: `out` within DECODE_TOL of `plain_decode_attention`, `m` and
     `l` within DECODE_ML_RTOL; rows outside the windows hold NaN for the
     kernel, which must not load them; merged with the current token against
     `two_part_cached_attention`. Timed over a stack of layers larger than the
     L2 cache, as a CUDA graph's replay (device time) and call by call (with
     the host's launch cost), beside its byte bound, the plain version, the eager
     `two_part_cached_attention` with one token and SDPA with a one-token
     query; and with every window DECODE_SHORT rows long, which must not take
     longer than full windows.
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
   Then the same int8 weights with every feed fused (`Precision.fuse_quant`
   and `quant_rows` at {"vit", "llm"}): per forward 48 attention, 48
   LayerNorm-quantize, 24 GELU-quantize, 48 identity-quantize (ViT proj and
   decoder wo), 48 RMSNorm-quantize and 24 SwiGLU-quantize launches; the
   readout against the same forward on the plain versions and against the
   fp32-activation forward of the same configuration (W8A8_READOUT_TOL,
   REF_RATIO), its cosine to bf16 at least W8A8_COSINE, and its cosine to the
   unfused W8A8 readout, printed with ms per chunk and peak memory.
6. slices (int8, int4): the same weights, seed and videos served weight-only
   (`build_serving_model(int8=True)` / `(int4=True)`): the ViT in bf16 on
   the fused-qkv kernel, the decoder's projections int8 or packed int4 on
   the weight-only matmuls, its attention on the three-tensor forward.
   Checks finite [4, 1] scores; per forward 24 fused-qkv launches, 24
   three-tensor launches and 120 of the one matmul kernel, none of the
   other, of the quantize feeds or of the training kernels; the readout of
   the kernel path against (a) the same model with every kernel swapped for
   its plain version and (b) the bf16 model whose decoder weights are the
   dequantized int8 / int4 values, both within WEIGHT_ONLY_READOUT_TOL; and
   prints the readout's cosine to the bf16 readout (int8: at least
   INT8_COSINE).

7. slice (train): stage-2 LoRA training of the same model
   (`cli/stage2_train.build_training_model`, rank 8 in both towers, bf16 with
   fp32 adapters and score head, per-layer checkpointing, adapter dropout
   0.05, drop path 0.1) through `train_steps`: TRAIN_STEPS optimizer steps on
   one batch of four videos with MOS from the seed, constant learning rate
   TRAIN_LR. Checks finite losses; per micro-batch 96 launches of the
   forward with logsumexp (the first pass and the recompute of 48 layers), 48
   of the dq and 48 of the dk/dv kernel, none of the forward without
   logsumexp; every frozen tensor bit-equal before and after; `lora_b`
   non-zero after step 1 in the first and last layer of both towers; the
   dropout-off loss on the batch lower after the steps than before; and, with
   dropout off, the adapters' gradients of a fixed linear functional of the
   readout (readout . u, u drawn from a seed) on the kernel path against the
   same backward through the plain attention, and both against an fp32
   backward of the same weights (tolerances at TRAIN_GRAD_TOL).

7b. stage 1: `cli/stage1_train.train_steps` on a stage-1 InternVL2-2B
   (no score head), TRAIN_STEPS steps on 4 videos x 8 frames x 448 px whose
   labels come from `data/preprocess.preprocess_internlm` on the answer
   STAGE1_ANSWER (the port's template and test tokenizer, no padding), bf16
   frozen towers, fp32 `mlp1` / `motion_mlp`, checkpointing on, drop path
   0.1, constant lr TRAIN_LR. Checks per micro-batch 24 launches of the
   forward without logsumexp (the frozen ViT runs no backward), 48 with it
   (the LLM's pass and recompute), 24 dq, 24 dk/dv; every tower and
   SlowFast tensor bit-equal and `mlp1` / `motion_mlp` moved; the losses
   finite and the dropout-off loss lower after the steps.

8. generation: `models/generation.generate` on the same model, B = 4, the
   2113-token prompt with the motion embedding, GEN_TOKENS new tokens,
   greedy, in bf16, with int8 weights, and in bf16 with the int8 KV cache.
   Checks [4, GEN_TOKENS] token ids; decode-attention launches = 24 x decode
   steps (0 under `kv_int8`), 121 int8 matmuls per prefill and per step, 24
   fused-qkv launches (the ViT); then, under a fixed token sequence
   (teacher forcing), the decode logits of the kernel path against the same
   steps on the plain decode attention and against the cache-free forward
   (DECODE_LOGITS_TOL), in bf16 also against an fp32 run of the same weights
   (REF_RATIO); token agreement where the top-two margin exceeds the
   measured difference; the cache rows against the cache-free forward's
   `capture_kv` rows. Prints ms per prefill and per decode step, tokens per
   second, cache bytes and peak memory.
9. shared prefix: P = 4 prompts that share their first 2081 tokens through
   `score_chunks(shared_prefix=True)` against `shared_prefix=False` on the
   same videos: launches per chunk (24 + 24 fused-qkv, no decode attention),
   the read-out rows within READOUT_TOL of each other and the shared path no
   more than REF_RATIO as far from an fp32 reference as the unshared one,
   scores within SCORE_TOL; ms per chunk and peak memory of both.
10. CLI: `cli/score.main`, the command users run, on 8 mp4 files (cv2, 30
    frames, 640 x 360) and one GIF written to a temporary directory: the 2B
    model from seed 0 served W8A8 with `AIGV_FUSE_QUANT=vit,llm
    AIGV_QUANT_ROWS=vit,llm`, two questions on the shared prefix, batch 4.
    Checks 9 CSV rows of 2 finite scores, the JSON summary line, and the
    RMSNorm- and SwiGLU-quantize launches of the run; prints videos per
    second with decode included and the decoder that ran.

11. InternVL2-26B (INTERNVL2_26B, the published config.json of
    OpenGVLab/InternVL2-26B through `AssessorConfig.from_dict`: InternViT-6B,
    45 layers, 25 heads of 128, RMSNorm, QK-normalization, no qkv bias;
    internlm2-chat-20b, 48 layers, 48 / 8 heads of 128), weights from seed 0,
    after every earlier model is freed.
    (a) At full width and DEPTH_CUT layers per tower: the readout of the
    kernel path against the plain path and both against an fp32 forward
    (READOUT_TOL, REF_RATIO), and the adapters' gradients of (readout . u),
    every adapter live, against the plain path and fp32 (TRAIN_GRAD_TOL,
    REF_RATIO).
    (b) Scoring one chunk of 4 videos in bf16 at full depth (47.5 GiB of
    weights, built straight in bf16): per forward 45 three-tensor (K2) and 48
    fused-qkv (K1) launches, finite scores and readout, the readout's
    distance to the plain path; ms per chunk, peak memory.
    (c) TRAIN_STEPS stage-2 LoRA steps at full depth through `train_steps`
    (r = 8 both towers, bf16 frozen, checkpointing, dropout 0.05, drop path
    0.1, micro-batch TRAIN_26B_VIDEOS videos): per micro-batch 90 K2
    logsumexp (pass and recompute), 45 K2 dq, 45 K2 dk/dv, 96 K1 lse, 48
    K3a, 48 K3b launches; the frozen tensors bit-equal to a host copy taken
    before the steps; ms per step, peak memory.

Then one JSON line describing the kernels, and last
{"ok": true, "device": {...}}. Imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import copy
import csv
import dataclasses
import io
import json
import os
import subprocess
import sys
import tempfile
import time
from unittest import mock

import numpy as np
import torch

TOL = 2e-2  # attention kernel vs plain, atol = rtol, bf16 outputs
# logsumexp: fp32 on both sides, exp2/log2 in the kernel against exp/log in
# the plain version; a few fp32 ulps at |lse| < 16
LSE_TOL = 1e-4
# backward kernels vs the plain backward, relative L2 of dq, dk, dv each. Both
# round p and ds to bf16 at the same places and sum in fp32, so what is left is
# the summation order and the bf16 rounding of the results (2^-9 relative per
# element at most): measured 6e-5 to 2.2e-4 on an H100
BWD_TOL = 2e-3
# Gradients of the adapters (dropout off), all of them as one vector, of a
# fixed linear functional of the readout, (readout . u).sum() with u from a
# seed, after 48 bf16 layers forward and 48 back. On an H100 the kernel path
# was 2.625e-2 from autograd through the plain attention, and 9.897e-2 and
# 9.711e-2 from the fp32 backward. (Through the L1 loss and the ReLU score
# head, as checked before, rounding moved the ReLU pattern of the random
# head: 1.057e-1 and 5.9e-1.) The kernel path must (a) stay within
# TRAIN_GRAD_TOL of the plain path and (b) be no more than REF_RATIO as far
# from the fp32 backward as the plain bf16 path is.
TRAIN_GRAD_TOL = 5e-2
TRAIN_STEPS, TRAIN_LR, LORA_RANK = 3, 4e-5, 8  # the shipping learning rate
PEAK_FLOPS, PEAK_BYTES = 989e12, 3.35e12  # H100 SXM: dense bf16, HBM3
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
# weight-only matmuls vs the plain version (fp32 products of the same bf16
# inputs, fp32 out): the summation order and one bf16 rounding of the result,
# 2^-9 relative per element at most. That rounding takes most of WO_TOL, so
# the kernel's bf16 output is also held against the plain version rounded to
# bf16: the fp32 sums differ by the summation order only, far below a bf16
# ulp, so nearly every element is the same bf16 value and the rest its
# neighbour. At most WO_UNEQUAL_SHARE of the elements may differ at all, at
# most WO_ULP_SHARE by more than one bf16 ulp (results near 0 after
# cancellation, where an ulp is smaller than the sums' rounding).
WO_TOL = 2e-3
WO_UNEQUAL_SHARE = 2e-2
WO_ULP_SHARE = 1e-3
# Weight-only readout after 24 bf16 ViT and 24 weight-only decoder layers. The
# weights are fixed integers, so nothing flips as under W8A8: the paths differ
# as two bf16 forwards do (2.03e-2 on an H100, above). (a) the plain path
# multiplies in fp32 and rounds each projection's output to bf16 like the
# kernels; (b) the bf16 model of the dequantized weights also rounds q * scale
# to bf16 where the kernels apply the scale to the fp32 sum.
WEIGHT_ONLY_READOUT_TOL = 5e-2
# int8 weight-only against bf16 of the same weights: the bound W8A8 is held to,
# which quantizes these weights and the activations too
INT8_COSINE = 0.99
# decode attention vs plain: `out` is bf16 (2^-9 relative), and the kernel
# keeps p in fp32 where the plain version rounds it to bf16, an error of the
# same size before the sum over the window averages it out
DECODE_TOL = 2e-2
# m and l: fp32 on both sides; __expf against exp and another summation order
DECODE_ML_RTOL = 1e-4
DECODE_SHORT = 64  # rows of a short window
# (B, hq, hkv, D, max_len, end, starts)
DECODE_SHAPES = {
    "path": (4, 16, 8, 128, 2177, 2113, (0, 0, 0, 0)),
    "ragged": (4, 16, 8, 128, 2177, 2150, (0, 500, 1500, 2100)),
    "end_zero": (4, 16, 8, 128, 2177, 0, (0, 0, 0, 0)),
    "one_row": (4, 16, 8, 128, 2177, 2113, (2112, 2112, 0, 2112)),
    "d64": (4, 16, 16, 64, 1100, 1025, (0, 0, 3, 1000)),
}
DECODE_LAYERS = 6  # cache layers cycled while timing: 214 MB, above the L2 cache
GEN_TOKENS = 32
FORCED = 8  # teacher-forced decode steps
# Decode logits after 24 bf16 layers, relative L2 over the forced steps. The
# kernel path and the plain path differ in the attention's rounding only, as
# two bf16 forwards do (2.03e-2 at the readout, above); the cache-free forward
# also takes another attention kernel and another rope layout.
DECODE_LOGITS_TOL = 3e-2
# the int8 cache rounds every cached value to 1 / 127 of its row's maximum
KV_INT8_LOGITS_TOL = 1e-1
PERSPECTIVES, SUFFIX = 4, 32  # prompts per video; tokens after the shared prefix
# Scores of the shared-prefix path against the unshared, largest difference
# over the largest score: a small head on readouts READOUT_TOL apart
SCORE_TOL = 5e-2
CTX = 7  # <IMG_CONTEXT> id of the synthetic prompts
FRAMES, IMAGE, TEXT, BATCH, CHUNKS = 8, 448, 64, 4, 2
# (B, hq, hkv, S, D, causal, kv_valid)
TRAIN_26B_VIDEOS = 2  # videos per micro-batch of the InternVL2-26B training phase
# K2's training forms on three tensors: (B, Sq, Skv, hq, hkv, D, causal,
# kv_valid, layout). InternViT-6B's attention over a scoring chunk's 32 frames
# and over a 26B training micro-batch's frames (q, k from the norms, v a
# strided view of the projection); the 2B decoder's row-major branch; a
# ragged non-causal Sq != Skv case with GQA and a garbage tail
SEPARATE_TRAIN = {
    "vit_6b": (32, 1032, 1032, 25, 25, 128, False, 1025, "bshd"),
    "vit_6b_train": (TRAIN_26B_VIDEOS * 8, 1032, 1032, 25, 25, 128, False, 1025, "bshd"),
    "llm_2b_rows": (4, 2113, 2113, 16, 8, 128, True, None, "bshd"),
    "cross": (2, 333, 1025, 8, 2, 128, False, 1000, "bhsd"),
}
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
    # the 2B decoder's feeds (4 videos x 2113 tokens) under fused W8A8
    "rmsnorm_quant": (8452, 2048, 48, "aigv_assessor_tpu/ops/quant_fuse.py:148"),
    "silu_mul_quant": (8452, 8192, 24, "aigv_assessor_tpu/ops/quant_fuse.py:160"),
}
WIDE_SILU = 14336  # the 8B decoder's SwiGLU feed: K5b's widest row
CLI_VIDEOS, CLI_FRAMES, CLI_SIZE = 8, 30, (640, 360)  # mp4 files; one GIF besides
RAGGED_ROWS = 1000
GRAPH_CALLS = 10  # launches of a feed kernel captured into one timed CUDA graph
# the 2B decoder's projections: (K, N, launches per layer)
PROJECTIONS = {
    "wqkv": (2048, 4096, 1),
    "wo": (2048, 2048, 1),
    "w1_w3": (2048, 8192, 2),
    "w2": (8192, 2048, 1),
}
PREFILL_ROWS = 4 * 2113
DECODE_ROWS = (4, 1)
LM_HEAD = (2048, 92553)
ODD_K = (2047, 4096)  # int4 pads a nibble, x loses its 16-byte rows
L2_BYTES = 50e6


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


def graph_ms(fns, iters: int) -> float:
    """Device time of one call: the calls `fns` are captured into one CUDA
    graph and replayed, so the host's launch cost is not in the time. -> ms
    per call."""
    fns[0]()  # builds and warms up outside the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for fn in fns:
            fn()
    return time_ms(graph.replay, iters) / len(fns)


def make_qkv(shape, device) -> torch.Tensor:
    b, hq, hkv, s, d, _, kv_valid = shape
    gen = torch.Generator(device=device).manual_seed(0)
    qkv = torch.randn((b, hq + 2 * hkv, s, d), generator=gen, device=device)
    if kv_valid is not None:  # a garbage tail: +-1e3 in k and v
        qkv[:, hq : hq + hkv, kv_valid:] = 1e3
        qkv[:, hq + hkv :, kv_valid:] = -1e3
    return qkv.to(torch.bfloat16)


def attention_work(shape) -> dict:
    """FLOPs and bytes of the fused-qkv attention kernels at one SHAPES
    entry: `separate_work` with Sq = Skv = S."""
    b, hq, hkv, s, d, causal, kv_valid = shape
    return separate_work((b, s, s, hq, hkv, d, causal, kv_valid, "bhsd"))


def bound_ms(flops: float, nbytes: float) -> tuple:
    t_ops, t_bytes = flops / PEAK_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def sdpa_views(qkv, shape, requires_grad=False):
    """q, k, v as `F.scaled_dot_product_attention` takes them: views of the
    fused array, k and v cut at kv_valid."""
    _, hq, hkv, _, _, _, kv_valid = shape
    q, k, v = qkv[:, :hq], qkv[:, hq : hq + hkv, :kv_valid], qkv[:, hq + hkv :, :kv_valid]
    if requires_grad:
        q, k, v = (t.detach().requires_grad_() for t in (q, k, v))
    return q, k, v


def sdpa(q, k, v, shape):
    return torch.nn.functional.scaled_dot_product_attention(
        q, k, v, is_causal=shape[5], enable_gqa=shape[1] != shape[2])


def check_attention(fa, device) -> dict:
    results = {}
    for name, shape in SHAPES.items():
        b, hq, hkv, s, d, causal, kv_valid = shape
        qkv = make_qkv(shape, device)
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
        with torch.no_grad():
            q, k, v = sdpa_views(qkv, shape)
            lib = sdpa(q, k, v, shape)
            lib_err = (lib.float() - want.float()).abs().max().item()
            library_ms = time_ms(lambda: sdpa(q, k, v, shape), 20)
        bound, bound_by = bound_ms(*attention_work(shape)["fwd"])
        text = f"B={b} hq={hq} hkv={hkv} S={s} D={d} causal={causal} kv_valid={kv_valid}"
        results[name] = dict(
            shape=text, max_abs_err=err, ms=ms, plain_ms=plain_ms,
            bsd_max_abs_err=err_dense, bsd_ms=ms_dense, bsd_plain_ms=plain_ms_dense,
            bound_ms=bound, bound_by=bound_by, library_ms=library_ms,
            library_max_abs_err=lib_err,
        )
        phase("kernel", f"attention {name}: {text} max_abs_err bhsd {err:.3e} bsd "
              f"{err_dense:.3e} (atol=rtol={TOL}), bsd == bhsd transposed exactly; "
              f"bhsd kernel {ms:.4f} ms, plain {plain_ms:.4f} ms; bsd kernel "
              f"{ms_dense:.4f} ms, plain {plain_ms_dense:.4f} ms; bound {bound:.4f} ms "
              f"({bound_by}); SDPA {library_ms:.4f} ms (max_abs_err to plain {lib_err:.3e})")
    return results


def check_attention_training(fa, device) -> dict:
    """The forward with logsumexp and the dq and dk/dv kernels."""
    results = {}
    for name, shape in SHAPES.items():
        b, hq, hkv, s, d, causal, kv_valid = shape
        qkv = make_qkv(shape, device)
        kw = dict(causal=causal, kv_valid=kv_valid)
        gen = torch.Generator(device=device).manual_seed(1)
        dout = torch.randn((b, hq, s, d), generator=gen, device=device)
        if kv_valid is not None:  # the callers' pad query rows carry no gradient
            dout[:, :, kv_valid:] = 0.0
        dout = dout.to(torch.bfloat16)

        out, lse = fa.flash_attention_qkv_lse(qkv, hq, hkv, **kw)
        no_lse = fa.flash_attention_qkv(qkv, hq, hkv, **kw)
        dqkv = fa.flash_attention_qkv_bwd(qkv, out, lse, dout, hq, hkv, **kw)
        torch.cuda.synchronize()
        if not torch.equal(out, no_lse):
            raise RuntimeError(f"{name}: out with logsumexp differs from out without")
        plain_out, plain_lse = fa.plain_attention_qkv(qkv, hq, hkv, return_lse=True, **kw)
        lse_err = (lse - plain_lse).abs().max().item()
        if not (torch.isfinite(lse).all() and lse_err <= LSE_TOL):
            raise RuntimeError(f"{name}: logsumexp max abs err {lse_err} above {LSE_TOL}")
        want = fa.plain_attention_qkv_bwd(qkv, out, lse, dout, hq, hkv, **kw)
        if not torch.isfinite(dqkv).all():
            raise RuntimeError(f"{name}: dqkv is not finite")
        parts = {"dq": slice(0, hq), "dk": slice(hq, hq + hkv), "dv": slice(hq + hkv, None)}
        rel = {k: relative_l2(dqkv[:, sl].float(), want[:, sl].float()) for k, sl in parts.items()}
        err = {k: (dqkv[:, sl].float() - want[:, sl].float()).abs().max().item()
               for k, sl in parts.items()}
        if not all(r <= BWD_TOL for r in rel.values()):
            raise RuntimeError(f"{name}: backward relative L2 {rel} above {BWD_TOL}")
        if kv_valid is not None and dqkv[:, hq:, kv_valid:].any():
            raise RuntimeError(f"{name}: dk/dv rows of masked keys are not exactly 0")
        del want, plain_out, plain_lse

        delta = (dout.float() * out.float()).sum(-1)
        args = (qkv, dout, lse, delta, dqkv, hq, hkv)
        ms_lse = time_ms(lambda: fa.flash_attention_qkv_lse(qkv, hq, hkv, **kw), 20)
        ms_dq = time_ms(lambda: fa.flash_attention_qkv_bwd_dq(*args, **kw), 20)
        ms_dkv = time_ms(lambda: fa.flash_attention_qkv_bwd_dkv(*args, **kw), 20)
        ms_delta = time_ms(lambda: (dout.float() * out.float()).sum(-1), 20)
        plain_lse_ms = time_ms(
            lambda: fa.plain_attention_qkv(qkv, hq, hkv, return_lse=True, **kw), 5)
        plain_bwd_ms = time_ms(
            lambda: fa.plain_attention_qkv_bwd(qkv, out, lse, dout, hq, hkv, **kw), 3, warmup=1)
        # the library's backward gives dq, dk and dv in one call
        q, k, v = sdpa_views(qkv, shape, requires_grad=True)
        lib_out = sdpa(q, k, v, shape)
        lib_grads = torch.autograd.grad(lib_out, (q, k, v), dout, retain_graph=True)
        lib_rel = {
            "dq": relative_l2(lib_grads[0].float(), dqkv[:, :hq].float()),
            "dk": relative_l2(lib_grads[1].float(), dqkv[:, hq : hq + hkv, :kv_valid].float()),
            "dv": relative_l2(lib_grads[2].float(), dqkv[:, hq + hkv :, :kv_valid].float()),
        }
        library_bwd_ms = time_ms(
            lambda: torch.autograd.grad(lib_out, (q, k, v), dout, retain_graph=True), 20)
        del lib_out, lib_grads, q, k, v
        work = attention_work(shape)
        bounds = {k: bound_ms(*work[k]) for k in ("fwd_lse", "dq", "dkv")}
        text = f"B={b} hq={hq} hkv={hkv} S={s} D={d} causal={causal} kv_valid={kv_valid}"
        results[name] = dict(
            shape=text, lse_max_abs_err=lse_err, rel_l2=rel, max_abs_err=err,
            lse_ms=ms_lse, dq_ms=ms_dq, dkv_ms=ms_dkv, delta_ms=ms_delta,
            plain_lse_ms=plain_lse_ms, plain_bwd_ms=plain_bwd_ms,
            library_bwd_ms=library_bwd_ms, library_rel_l2=lib_rel,
            bounds={k: dict(bound_ms=v[0], bound_by=v[1]) for k, v in bounds.items()},
        )
        phase("kernel", f"attention training {name}: {text}: out bit-equal with and without "
              f"lse, lse max_abs_err {lse_err:.3e} (tol {LSE_TOL}); rel L2 dq {rel['dq']:.3e} "
              f"dk {rel['dk']:.3e} dv {rel['dv']:.3e} (tol {BWD_TOL}), masked-key rows "
              f"exactly 0; fwd+lse {ms_lse:.4f} ms (plain {plain_lse_ms:.4f}, bound "
              f"{bounds['fwd_lse'][0]:.4f}), dq {ms_dq:.4f} ms (bound {bounds['dq'][0]:.4f}), "
              f"dk/dv {ms_dkv:.4f} ms (bound {bounds['dkv'][0]:.4f}), delta {ms_delta:.4f} ms, "
              f"plain backward {plain_bwd_ms:.4f} ms, SDPA backward {library_bwd_ms:.4f} ms "
              f"(rel L2 to the kernels dq {lib_rel['dq']:.3e} dk {lib_rel['dk']:.3e} dv "
              f"{lib_rel['dv']:.3e})")
    return results


def feed_inputs(name: str, rows: int, cols: int, device) -> tuple:
    gen = torch.Generator(device=device).manual_seed(1)
    x = (2.0 * torch.randn((rows, cols), generator=gen, device=device)).to(torch.bfloat16)
    if name == "silu_mul_quant":
        return x, (2.0 * torch.randn((rows, cols), generator=gen, device=device)).to(
            torch.bfloat16)
    if name not in ("ln_quant", "rmsnorm_quant"):
        return (x,)
    w = (1.0 + 0.2 * torch.randn(cols, generator=gen, device=device)).to(torch.bfloat16)
    if name == "rmsnorm_quant":
        return x, w
    b = (0.1 * torch.randn(cols, generator=gen, device=device)).to(torch.bfloat16)
    return x, w, b


def feed_bound(name: str, rows: int, cols: int) -> tuple:
    """(bound ms, bound_by) of one launch: bf16 in (two inputs for silu-mul,
    and the norm's weight and bias), int8 and one fp32 scale per row out; some
    ten fp32 operations per element outside the tensor cores (67 TFLOP/s)."""
    inputs = 2 if name == "silu_mul_quant" else 1
    vectors = {"ln_quant": 2, "rmsnorm_quant": 1}.get(name, 0)
    nbytes = rows * cols * (2 * inputs + 1) + rows * 4 + 2 * vectors * cols
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, 10 * rows * cols / 67e12 * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def check_feeds(qf, device) -> dict:
    calls = {
        "ln_quant": (qf.layernorm_quant, qf.plain_layernorm_quant),
        "gelu_quant": (qf.gelu_quant, qf.plain_gelu_quant),
        "ident_quant": (qf.quant_rows, qf.plain_quant_rows),
        "rmsnorm_quant": (qf.rmsnorm_quant, qf.plain_rmsnorm_quant),
        "silu_mul_quant": (qf.silu_mul_quant, qf.plain_silu_mul_quant),
    }
    results = {}
    for name, (rows, cols, _, _) in FEEDS.items():
        kernel, plain = calls[name]
        stats = {}
        shapes = [("path", rows, cols), ("ragged", RAGGED_ROWS, cols)]
        if name == "silu_mul_quant":
            shapes.append(("wide", rows, WIDE_SILU))
        if name == "ident_quant":  # the decoder's wo feed under fused W8A8
            shapes.append(("decoder_wo", PREFILL_ROWS, FEEDS["rmsnorm_quant"][1]))
        for label, n, c in shapes:
            args = feed_inputs(name, n, c, device)
            q, s = kernel(*args)
            torch.cuda.synchronize()
            q2, s2 = plain(*args)
            if q.dtype != torch.int8 or q.shape != (n, c) or s.shape != (n, 1):
                raise RuntimeError(f"{name}: outputs {q.dtype} {tuple(q.shape)} {tuple(s.shape)}")
            scale_err = ((s - s2).abs() / s2.abs()).max().item()
            diff = (q.int() - q2.int()).abs()
            flips = (diff > 0).float().mean().item()
            if not (scale_err <= SCALE_RTOL and diff.max().item() <= 1
                    and flips <= FLIP_FRACTION):
                raise RuntimeError(
                    f"{name} at {n}x{c}: scale rel err {scale_err:.3e} (tol "
                    f"{SCALE_RTOL}), int8 max diff {diff.max().item()}, flipped "
                    f"share {flips:.3e} (tol {FLIP_FRACTION})")
            deq_err = (q.float() * s - q2.float() * s2).abs().max().item()
            stats[label] = dict(rows=n, cols=c, scale_rel_err=scale_err, flipped_share=flips,
                                dequant_max_abs_err=deq_err)
            if label != "ragged":
                # device time by graph replay: a launch of the smaller feeds
                # takes less device time than the wrapper's host cost, so
                # call by call the loop would time the host
                r = stats[label]
                r["ms"] = graph_ms([lambda: kernel(*args)] * GRAPH_CALLS, 20)
                r["call_ms"] = time_ms(lambda: kernel(*args), 20)
                r["plain_ms"] = graph_ms([lambda: plain(*args)] * GRAPH_CALLS, 5)
                r["bound_ms"], r["bound_by"] = feed_bound(name, n, c)
            del args, q, s, q2, s2, diff
        p = stats["path"]
        results[name] = dict(
            cols=cols, ms=p["ms"], plain_ms=p["plain_ms"], bound_ms=p["bound_ms"],
            bound_by=p["bound_by"], shapes=stats,
            max_abs_err=max(r["dequant_max_abs_err"] for r in stats.values()),
        )
        text = "; ".join(
            f"{r['rows']}x{r['cols']}: scale rel err {r['scale_rel_err']:.3e}, int8 flipped "
            f"share {r['flipped_share']:.3e}" + (
                f", kernel {r['ms']:.4f} ms (call by call, host included: {r['call_ms']:.4f}), "
                f"plain {r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']})"
                if "ms" in r else "")
            for r in stats.values())
        phase("kernel", f"{name} bf16 (tol: scales {SCALE_RTOL}, flips {FLIP_FRACTION} each "
              f"by one): {text}")
    return results


def check_attention_separate(fa, device) -> dict:
    """The forward on three separate tensors: against its plain version,
    against the fused-qkv kernel on the same data, and timed at the two
    shapes of the 2B model."""
    results = {}

    def compare(name, q, k, v, kw, fused=None):
        got = fa.flash_attention(q, k, v, **kw)
        torch.cuda.synchronize()
        want = fa.plain_flash_attention(q, k, v, **kw)
        if got.shape != q.shape or not torch.isfinite(got).all():
            raise RuntimeError(f"three-tensor attention at {name}: output not finite {q.shape}")
        torch.testing.assert_close(got.float(), want.float(), atol=TOL, rtol=TOL)
        err = (got.float() - want.float()).abs().max().item()
        equal = None if fused is None else torch.equal(got.reshape(fused.shape), fused)
        diff = (None if fused is None else
                (got.reshape(fused.shape).float() - fused.float()).abs().max().item())
        if fused is not None and not equal:  # one body: the fused kernel's check covers this one
            raise RuntimeError(f"three-tensor attention at {name}: not bit-equal to the "
                               f"fused-qkv kernel on the same data, max abs diff {diff:.3e}")
        return got, want, err, equal, diff

    def sdpa_ms(q, k, v, kw, want, layout):
        # the library takes head-major tensors: views, no copy; kv_valid by slicing
        if layout == "bshd":
            q, k, v = (t.transpose(1, 2) for t in (q, k, v))
        kv_valid = kw.get("kv_valid")
        k, v = k[:, :, :kv_valid], v[:, :, :kv_valid]
        gqa = q.shape[1] != k.shape[1]

        def call():
            return torch.nn.functional.scaled_dot_product_attention(
                q, k, v, is_causal=kw.get("causal", False), enable_gqa=gqa)
        with torch.no_grad():
            lib = call()
            if layout == "bshd":
                lib = lib.transpose(1, 2)
            lib_err = (lib.float() - want.float()).abs().max().item()
            return time_ms(call, 20), lib_err

    # the LLM's call: [B, S, H, D] views of one row-major projection output
    b, hq, hkv, s, d, _, _ = SHAPES["llm"]
    gen = torch.Generator(device=device).manual_seed(2)
    proj = torch.randn((b, s, (hq + 2 * hkv) * d), generator=gen, device=device).to(torch.bfloat16)
    q = proj[..., : hq * d].view(b, s, hq, d)
    k = proj[..., hq * d : (hq + hkv) * d].view(b, s, hkv, d)
    v = proj[..., (hq + hkv) * d :].view(b, s, hkv, d)
    kw = dict(causal=True)
    fused = fa.flash_attention_qkv(proj.view(b, s, hq + 2 * hkv, d).transpose(1, 2), hq, hkv,
                                   causal=True, out_layout="bsd")
    _, want, err, equal, diff = compare("llm", q, k, v, kw, fused)
    ms = time_ms(lambda: fa.flash_attention(q, k, v, **kw), 20)
    plain_ms = time_ms(lambda: fa.plain_flash_attention(q, k, v, **kw), 5)
    library_ms, lib_err = sdpa_ms(q, k, v, kw, want, "bshd")
    bound, bound_by = bound_ms(*attention_work(SHAPES["llm"])["fwd"])
    results["llm"] = dict(
        shape=f"bshd views of one [B, S, {(hq + 2 * hkv) * d}] projection, B={b} hq={hq} "
        f"hkv={hkv} S={s} D={d} causal", max_abs_err=err, equals_fused=equal,
        max_abs_diff_to_fused=diff, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
        library_max_abs_err=lib_err, bound_ms=bound, bound_by=bound_by)

    # the ViT's shape as separate tensors with a garbage tail, both layouts
    shape = SHAPES["vit"]
    b, hq, hkv, s, d, _, kv_valid = shape
    qkv = make_qkv(shape, device)
    kw = dict(kv_valid=kv_valid)
    parts = (qkv[:, :hq], qkv[:, hq : hq + hkv], qkv[:, hq + hkv :])
    fused = {"bhsd": fa.flash_attention_qkv(qkv, hq, hkv, **kw),
             "bshd": fa.flash_attention_qkv(qkv, hq, hkv, out_layout="bsd", **kw)}
    bound, bound_by = bound_ms(*attention_work(shape)["fwd"])
    for layout in ("bhsd", "bshd"):
        q, k, v = parts if layout == "bhsd" else (t.transpose(1, 2) for t in parts)
        kwl = dict(layout=layout, **kw)
        _, want, err, equal, diff = compare(f"vit {layout}", q, k, v, kwl, fused[layout])
        ms = time_ms(lambda: fa.flash_attention(q, k, v, **kwl), 20)
        plain_ms = time_ms(lambda: fa.plain_flash_attention(q, k, v, **kwl), 5)
        library_ms, lib_err = sdpa_ms(q, k, v, kw, want, layout)
        results[f"vit_{layout}"] = dict(
            shape=f"{layout} views of the fused array, B={b} H={hq} S={s} D={d} "
            f"kv_valid={kv_valid}", max_abs_err=err, equals_fused=equal,
            max_abs_diff_to_fused=diff, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
            library_max_abs_err=lib_err, bound_ms=bound, bound_by=bound_by)

    # non-causal with Sq != Skv, and the ragged shape with its garbage tail
    gen = torch.Generator(device=device).manual_seed(3)
    q, k, v = (torch.randn((8, n, 16, 64), generator=gen, device=device).to(torch.bfloat16)
               for n in (257, 1025, 1025))
    _, _, err, _, _ = compare("cross", q, k, v, {})
    results["cross"] = dict(shape="bshd B=8 H=16 Sq=257 Skv=1025 D=64", max_abs_err=err)
    shape = SHAPES["ragged"]
    _, hq, hkv, _, _, _, kv_valid = shape
    qkv = make_qkv(shape, device)
    parts = (qkv[:, :hq], qkv[:, hq : hq + hkv], qkv[:, hq + hkv :])
    fused = fa.flash_attention_qkv(qkv, hq, hkv, kv_valid=kv_valid)
    _, _, err, equal, diff = compare("ragged", *parts, dict(layout="bhsd", kv_valid=kv_valid),
                                     fused)
    results["ragged"] = dict(shape="bhsd B=2 H=4 S=200 D=64 kv_valid=150", max_abs_err=err,
                             equals_fused=equal, max_abs_diff_to_fused=diff)
    for name, r in results.items():
        timed = (f"; kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, bound "
                 f"{r['bound_ms']:.4f} ms ({r['bound_by']}), SDPA {r['library_ms']:.4f} ms "
                 f"(max_abs_err to plain {r['library_max_abs_err']:.3e})" if "ms" in r else "")
        fused_text = ("" if r.get("equals_fused") is None else
                      f", bit-equal to the fused-qkv kernel: {r['equals_fused']} (max abs "
                      f"diff {r['max_abs_diff_to_fused']:.3e})")
        phase("kernel", f"three-tensor attention {name}: {r['shape']}: max_abs_err "
              f"{r['max_abs_err']:.3e} (atol=rtol={TOL}){fused_text}{timed}")
    return results


def check_weight_only(wo, device) -> dict:
    """The int8 and int4 matmuls against their plain versions: at the
    decoder's shapes with the prefill's rows (timed), at the decode sizes
    (timed with every weight read from device memory), at the LM head and,
    for int4, at an odd K."""
    results = {}
    shares = []  # per comparison: (share of elements unequal, share beyond one bf16 ulp)
    gen = torch.Generator(device=device).manual_seed(4)

    def operands(bits, m, k, n):
        x = torch.randn((m, k), generator=gen, device=device).to(torch.bfloat16)
        w = torch.randn((n, k), generator=gen, device=device) * 0.02
        w[n // 2] = 0.0  # an all-zero output channel: scale 1, output exactly 0
        q, scale = (wo.quantize_weight if bits == 8 else wo.quantize_kernel_int4)(w)
        deq = (wo.dequantize_kernel(q, scale, torch.bfloat16) if bits == 8 else
               wo.dequantize_kernel_int4(q, scale, k, torch.bfloat16))
        return x, q, scale, deq

    def compare(label, kernel, plain, x, q, scale):
        n = q.shape[0]
        got = kernel(x, q, scale)
        torch.cuda.synchronize()
        want = plain(x, q, scale, out_dtype=torch.float32)
        rel = relative_l2(got.float(), want)
        if not (torch.isfinite(got).all() and rel <= WO_TOL):
            raise RuntimeError(f"{label}: relative L2 to the plain version {rel} above {WO_TOL}")
        if scale[n // 2] != 1.0 or got[:, n // 2].any():
            raise RuntimeError(f"{label}: an all-zero weight column did not give exactly 0")
        rounded = want.to(torch.bfloat16).float()
        diff = (got.float() - rounded).abs()
        ulp = torch.ldexp(torch.ones_like(rounded), torch.frexp(rounded).exponent - 8)
        unequal, beyond = (diff > 0).float().mean().item(), (diff > ulp).float().mean().item()
        if unequal > WO_UNEQUAL_SHARE or beyond > WO_ULP_SHARE:
            raise RuntimeError(
                f"{label}: against the plain version rounded to bf16, {unequal:.3e} of the "
                f"elements differ (tol {WO_UNEQUAL_SHARE}) and {beyond:.3e} by more than one "
                f"bf16 ulp (tol {WO_ULP_SHARE})")
        shares.append((unequal, beyond))
        return rel, (got.float() - want).abs().max().item()

    def work(bits, m, k, n):
        return 2.0 * m * n * k, 2 * m * k + n * ((k + 1) // 2 if bits == 4 else k) + 4 * n + 2 * m * n

    for bits, kernel, plain in ((8, wo.int8_matmul, wo.plain_int8_matmul),
                                (4, wo.int4_matmul, wo.plain_int4_matmul)):
        table = {}
        for name, (k, n, _) in PROJECTIONS.items():
            x, q, scale, deq = operands(bits, PREFILL_ROWS, k, n)
            rel, err = compare(f"int{bits} {name}", kernel, plain, x, q, scale)
            bound, bound_by = bound_ms(*work(bits, PREFILL_ROWS, k, n))
            entry = dict(
                K=k, N=n, M=PREFILL_ROWS, rel_l2=rel, max_abs_err=err,
                ms=time_ms(lambda: kernel(x, q, scale), 10),
                plain_ms=time_ms(lambda: plain(x, q, scale), 3, warmup=1),
                library_ms=time_ms(lambda: torch.nn.functional.linear(x, deq), 10),
                bound_ms=bound, bound_by=bound_by, decode={})
            # decode sizes: cycle over copies of the weight that together
            # exceed the L2 cache, as a decoder walking its layers finds them
            copies = int(L2_BYTES * 2 // q.numel()) + 1
            qs, deqs = [q.clone() for _ in range(copies)], [deq.clone() for _ in range(copies)]
            for m in DECODE_ROWS:
                xm = x[:m].contiguous()
                rel_m, err_m = compare(f"int{bits} {name} M={m}", kernel, plain, xm, q, scale)

                def cycle(fn, ws):
                    def run():
                        for w in ws:
                            fn(w)
                    return time_ms(run, 5, warmup=1) / len(ws)
                b_m, by_m = bound_ms(*work(bits, m, k, n))
                entry["decode"][m] = dict(
                    rel_l2=rel_m, max_abs_err=err_m, weight_copies=copies,
                    ms=cycle(lambda w: kernel(xm, w, scale), qs),
                    library_ms=cycle(lambda w: torch.nn.functional.linear(xm, w), deqs),
                    bound_ms=b_m, bound_by=by_m)
            del qs, deqs
            table[name] = entry
            dec = ", ".join(
                f"M={m}: rel L2 {r['rel_l2']:.3e}, kernel {r['ms'] * 1e3:.1f} us, F.linear "
                f"{r['library_ms'] * 1e3:.1f} us, bound {r['bound_ms'] * 1e3:.2f} us "
                f"({r['bound_by']})" for m, r in entry["decode"].items())
            phase("kernel", f"int{bits} matmul {name} K={k} N={n} M={PREFILL_ROWS}: rel L2 to "
                  f"plain {rel:.3e} (tol {WO_TOL}), max_abs_err {err:.3e}, zero column exactly "
                  f"0; kernel {entry['ms']:.4f} ms ({2e-9 * PREFILL_ROWS * k * n / entry['ms']:.1f} "
                  f"TFLOP/s), plain {entry['plain_ms']:.4f} ms, F.linear bf16 on the dequantized "
                  f"weight {entry['library_ms']:.4f} ms, bound {bound:.4f} ms ({bound_by}); "
                  f"decode, weights from device memory ({copies} copies): {dec}")
        # the LM head: N off every tile, rows of y off their 4-byte alignment
        k, n = LM_HEAD
        x, q, scale, deq = operands(bits, DECODE_ROWS[0], k, n)
        rel, err = compare(f"int{bits} LM head", kernel, plain, x, q, scale)
        b_h, by_h = bound_ms(*work(bits, DECODE_ROWS[0], k, n))
        table["lm_head"] = dict(
            K=k, N=n, M=DECODE_ROWS[0], rel_l2=rel, max_abs_err=err,
            ms=time_ms(lambda: kernel(x, q, scale), 10),
            library_ms=time_ms(lambda: torch.nn.functional.linear(x, deq), 10),
            bound_ms=b_h, bound_by=by_h)
        h = table["lm_head"]
        phase("kernel", f"int{bits} matmul LM head K={k} N={n} M={DECODE_ROWS[0]}: rel L2 {rel:.3e}, "
              f"kernel {h['ms']:.4f} ms, F.linear {h['library_ms']:.4f} ms, bound {b_h:.4f} ms "
              f"({by_h})")
        del x, q, scale, deq
        if bits == 4:
            k, n = ODD_K
            x, q, scale, _ = operands(bits, DECODE_ROWS[0], k, n)
            rel, err = compare("int4 odd K", kernel, plain, x, q, scale)
            table["odd_k"] = dict(K=k, N=n, M=DECODE_ROWS[0], rel_l2=rel, max_abs_err=err)
            phase("kernel", f"int4 matmul odd K={k} N={n} M={DECODE_ROWS[0]}: rel L2 {rel:.3e}")
        results[bits] = table
        phase("kernel", f"int{bits} matmul against the plain version rounded to bf16, worst of "
              f"{len(shares)} shapes: {max(u for u, _ in shares):.3e} of the elements differ "
              f"(tol {WO_UNEQUAL_SHARE}), {max(b for _, b in shares):.3e} by more than one "
              f"bf16 ulp (tol {WO_ULP_SHARE})")
        shares.clear()
    return results


def relative_l2(x: torch.Tensor, y: torch.Tensor) -> float:
    return ((x - y).norm() / y.norm()).item()


def run_train_slice(cfg, device, ids, mask, px_u8, rng, per_forward: int, smi: str) -> dict:
    """Phase 7 -> launches of each attention kernel form over the
    TRAIN_STEPS steps. per_forward: attention layers of one forward."""
    from aigv_assessor_torch.cli.stage2_train import (
        LORA_FILE, build_training_model, prepare_batch, train_steps)
    from aigv_assessor_torch.core.precision import Precision
    from aigv_assessor_torch.models.lora import set_generator
    from aigv_assessor_torch.ops import flash_attention as fa
    from aigv_assessor_torch.train.trainer import TrainConfig, Trainer

    batch_size, seq = ids.shape[0], ids.shape[-1]
    # same seed as the serving slices, so the same frozen weights
    lora_cfg = cfg.replace(use_backbone_lora=LORA_RANK, use_llm_lora=LORA_RANK)
    t0 = time.perf_counter()
    model = build_training_model(lora_cfg, device=device, seed=0)
    with torch.no_grad():
        # the score head ends in a ReLU; positive last-layer weights keep it
        # open for every sample whatever the seed drew, so the loss has a
        # gradient to follow
        getattr(model.mlpscore, f"fc{model.mlpscore.num_layers}").weight.abs_()
    mos = torch.as_tensor(rng.uniform(20.0, 90.0, batch_size), dtype=torch.float32)
    batch = {"input_ids": ids[:, 0], "pixels_u8": px_u8, "attention_mask": mask[:, 0],
             "mos": mos}
    train_kernels = (fa.flash_attention_qkv, fa.flash_attention_qkv_lse,
                     fa.flash_attention_qkv_bwd_dq, fa.flash_attention_qkv_bwd_dkv)
    with tempfile.TemporaryDirectory() as out_dir:
        tc = TrainConfig(output_dir=out_dir, learning_rate=TRAIN_LR, warmup_ratio=0.0,
                         lr_scheduler_type="constant", num_train_epochs=1, save_steps=0, seed=0)
        trainer = Trainer(model, tc, TRAIN_STEPS)  # freezes; frozen part to bf16
        torch.cuda.synchronize()
        init_train_s = time.perf_counter() - t0
        trained = set(trainer.trainable)
        n_trainable = sum(p.numel() for p in trainer.trainable_parameters().values())
        weights_train = torch.cuda.memory_allocated(device) / 2**30
        frozen = {n: t.detach().clone() for n, t in model.state_dict().items()
                  if n not in trained}
        prepared = prepare_batch(model, **batch)

        def eval_loss() -> float:
            model.eval()
            with torch.no_grad():
                return model(prepared["input_ids"], prepared["pixel_values"],
                             prepared["attention_mask"], mos=prepared["mos"])["loss"].item()

        loss_before = eval_loss()
        torch.cuda.reset_peak_memory_stats(device)
        for c in train_kernels:
            c.launches = 0
        t0 = time.perf_counter()
        train_steps(model, [batch], tc, trainer=trainer)  # step 1
        torch.cuda.synchronize()
        step1_ms = (time.perf_counter() - t0) * 1e3
        towers = (model.vision_model.layers, model.language_model.layers)
        ends = [m for layers in towers for layer in (layers[0], layers[-1])
                for m in layer.modules() if hasattr(m, "lora_b")]
        if len(ends) != 2 * 4 + 2 * 5 or not all(m.lora_b.any() for m in ends):
            raise RuntimeError("a lora_b of a first or last layer is still zero after step 1")
        t0 = time.perf_counter()
        train_steps(model, [batch] * (TRAIN_STEPS - 1), tc, trainer=trainer)
        torch.cuda.synchronize()
        later_ms = (time.perf_counter() - t0) * 1e3 / (TRAIN_STEPS - 1)
        train_counts = {c.__name__: c.launches for c in train_kernels}
        peak_train = torch.cuda.max_memory_allocated(device) / 2**30
        with open(f"{out_dir}/train_log.jsonl") as f:
            log = [json.loads(line) for line in f]
        losses = [r["loss"] for r in log]
        # between two steps of one call: the step alone, batch preparation
        # included, the LoRA dump not
        steady_ms = (log[-1]["time"] - log[-2]["time"]) * 1e3
        lora_bytes = os.path.getsize(f"{out_dir}/{LORA_FILE}")
    want = {"flash_attention_qkv": 0,
            "flash_attention_qkv_lse": 2 * per_forward * TRAIN_STEPS,
            "flash_attention_qkv_bwd_dq": per_forward * TRAIN_STEPS,
            "flash_attention_qkv_bwd_dkv": per_forward * TRAIN_STEPS}
    if train_counts != want:
        raise RuntimeError(f"train: launches {train_counts} for {TRAIN_STEPS} steps of one "
                           f"micro-batch, expected {want}")
    if len(losses) != TRAIN_STEPS or not np.isfinite(losses).all() or trainer.step != TRAIN_STEPS:
        raise RuntimeError(f"train: losses {losses} after {trainer.step} steps")
    moved = [n for n, t in model.state_dict().items() if n in frozen and not torch.equal(t, frozen[n])]
    if moved:
        raise RuntimeError(f"train: frozen tensors changed: {moved[:5]}")
    del frozen
    loss_after = eval_loss()
    if not loss_after < loss_before:
        raise RuntimeError(f"train: dropout-off loss {loss_before} before, {loss_after} after "
                           f"{TRAIN_STEPS} steps at lr {TRAIN_LR}")

    # a fixed linear functional of the readout: its gradient reaches every
    # adapter, and no ReLU of the random score head decides which
    u = torch.randn((batch_size, cfg.llm.hidden_size), device=device,
                    generator=torch.Generator(device=device).manual_seed(7))

    def eval_grads(m) -> torch.Tensor:
        """Dropout off (eval mode), checkpointing on: the adapters' gradients
        of (readout . u).sum() as one fp32 vector."""
        m.eval()
        for p in m.parameters():
            p.grad = None
        dtype = m.precision.compute_dtype
        readout = m(prepared["input_ids"], prepared["pixel_values"].to(dtype),
                    prepared["attention_mask"], mos=prepared["mos"])["readout"]
        (readout.float() * u).sum().backward()
        return torch.cat([p.grad.float().flatten() for n, p in m.named_parameters()
                          if n in trained and p.grad is not None])

    before = [c.launches for c in train_kernels]
    g_kernel = eval_grads(model)
    if [c.launches - b for c, b in zip(train_kernels, before)] != [0, 2 * per_forward,
                                                                   per_forward, per_forward]:
        raise RuntimeError("the dropout-off backward did not go through the kernels")
    launched = [c.launches for c in train_kernels]
    set_generator(model, None)  # eval mode draws nothing
    ref = copy.deepcopy(model).float()
    ref.precision = Precision.fp32()
    # autograd through the plain forward, in bf16 and in fp32
    with mock.patch.object(fa, "flash_attention_qkv", fa.plain_attention_qkv):
        g_plain = eval_grads(model)
        g_ref = eval_grads(ref)
    if [c.launches for c in train_kernels] != launched:
        raise RuntimeError("the plain backwards launched a kernel")
    del ref
    if not g_kernel.numel() == g_plain.numel() == g_ref.numel() > 0:
        raise RuntimeError("train: the three backwards reached other adapters")
    gk, gp, gr = relative_l2(g_kernel, g_plain), relative_l2(g_kernel, g_ref), relative_l2(
        g_plain, g_ref)
    if not torch.isfinite(g_kernel).all() or not gk <= TRAIN_GRAD_TOL:
        raise RuntimeError(f"train: gradient relative L2 kernel vs plain {gk} above "
                           f"{TRAIN_GRAD_TOL}")
    if not gr <= REF_RATIO * gp:
        raise RuntimeError(f"train: kernel-path gradient {gr} from the fp32 reference, plain "
                           f"bf16 path {gp}: more than {REF_RATIO}x farther")
    per_step = {k: v // TRAIN_STEPS for k, v in train_counts.items()}
    phase("slice", f"train InternVL2-2B stage 2, LoRA r={LORA_RANK} both towers, bf16 with "
          f"fp32 masters ({n_trainable} trainable values), checkpointing on, dropout "
          f"{lora_cfg.lora_dropout}, drop path {cfg.vision.drop_path_rate}, {batch_size} videos x "
          f"{px_u8.shape[1]} frames {px_u8.shape[2]}px, seq {seq}, {TRAIN_STEPS} steps at constant lr {TRAIN_LR}: "
          f"launches per micro-batch {per_step}; {steady_ms:.1f} ms/step (the last); with "
          f"the LoRA dump of {lora_bytes} bytes, step 1 {step1_ms:.1f} ms, later steps "
          f"{later_ms:.1f} ms/step; peak "
          f"{peak_train:.2f} GiB allocated (weights {weights_train:.2f} GiB), init "
          f"{init_train_s:.1f} s; training losses {np.round(losses, 5).tolist()}; dropout-off "
          f"loss {loss_before:.5f} -> {loss_after:.5f}; frozen tensors bit-equal; adapter "
          f"gradients of (readout . u) ({g_kernel.numel()} values) rel L2 kernel vs plain "
          f"{gk:.3e} (tol {TRAIN_GRAD_TOL}), vs fp32 reference: kernel "
          f"{gr:.3e}, plain {gp:.3e} (tol {REF_RATIO}x) [{smi}]")
    return train_counts


def check_decode_attention(dec, two_part, device) -> dict:
    """The decode-attention kernel against its plain version at DECODE_SHAPES,
    merged against `two_part_cached_attention`, and timed at the path shape."""
    results = {}
    for name, (b, hq, hkv, d, max_len, end_i, starts_t) in DECODE_SHAPES.items():
        gen = torch.Generator(device=device).manual_seed(5)
        q = torch.randn((b, hq, d), generator=gen, device=device).to(torch.bfloat16)
        # layers of a stacked cache, read through their strides
        stack = torch.randn((2, DECODE_LAYERS, b, max_len, hkv, d), generator=gen,
                            device=device).to(torch.bfloat16)
        ck, cv = stack[0, 1], stack[1, 1]
        k_new, v_new = (torch.randn((b, 1, hkv, d), generator=gen, device=device)
                        .to(torch.bfloat16) for _ in range(2))
        starts = torch.tensor(starts_t, dtype=torch.int32, device=device)
        end = torch.tensor(end_i, dtype=torch.int32, device=device)
        rows = torch.arange(max_len, device=device)
        inside = (rows[None] >= starts[:, None]) & (rows[None] < end)
        ck_nan, cv_nan = ck.clone(), cv.clone()
        ck_nan[~inside] = float("nan")
        cv_nan[~inside] = float("nan")
        out, m, l = dec.decode_attention(q, ck_nan, cv_nan, starts, end)
        torch.cuda.synchronize()
        w_out, w_m, w_l = dec.plain_decode_attention(q, ck, cv, starts, end)
        if not (torch.isfinite(out).all() and torch.isfinite(m).all() and torch.isfinite(l).all()):
            raise RuntimeError(f"decode attention {name}: a row outside the window was read, "
                               "or the output is not finite")
        err = (out.float() - w_out.float()).abs().max().item()
        torch.testing.assert_close(out.float(), w_out.float(), atol=DECODE_TOL, rtol=DECODE_TOL)
        torch.testing.assert_close(m, w_m, atol=1e-5, rtol=DECODE_ML_RTOL)
        torch.testing.assert_close(l, w_l, atol=1e-6, rtol=DECODE_ML_RTOL)
        empty = ~inside.any(dim=1)
        if out[empty].any() or l[empty].any() or not (m[empty] == -1e30).all():
            raise RuntimeError(f"decode attention {name}: an empty window did not give "
                               "out = 0, l = 0, m = -1e30")
        kv_mask = rows[None] >= starts[:, None]
        merged = dec.cached_decode_attention(q[:, None], k_new, v_new, ck, cv, end, kv_mask)
        want = two_part(q[:, None], k_new, v_new, ck, cv, end_i, kv_mask)
        merged_err = (merged.float() - want.float()).abs().max().item()
        torch.testing.assert_close(merged.float(), want.float(), atol=DECODE_TOL, rtol=DECODE_TOL)
        n_rows = int(inside.sum())
        r = dict(shape=f"B={b} hq={hq} hkv={hkv} D={d} max_len={max_len} end={end_i} "
                 f"starts={list(starts_t)}", rows=n_rows, max_abs_err=err,
                 merged_max_abs_err=merged_err,
                 m_max_rel_err=((m - w_m).abs() / w_m.abs().clamp_min(1e-6)).max().item(),
                 l_max_rel_err=((l - w_l).abs() / w_l.abs().clamp_min(1e-6)).max().item())
        if name in ("path", "ragged"):
            layers = [(stack[0, i], stack[1, i]) for i in range(DECODE_LAYERS)]

            def cycle(fn, iters=5):
                """Device ms per call over the stack's layers (graph replay),
                and ms per call of the same calls made one by one, which on
                a small kernel is the host's launch cost."""
                calls = [lambda lk=lk, lv=lv: fn(lk, lv) for lk, lv in layers]

                def run():
                    for call in calls:
                        call()
                return graph_ms(calls, iters), time_ms(run, iters, warmup=2) / len(layers)
            r["ms"], r["eager_ms"] = cycle(
                lambda lk, lv: dec.decode_attention(q, lk, lv, starts, end), 20)
            r["plain_ms"], _ = cycle(
                lambda lk, lv: dec.plain_decode_attention(q, lk, lv, starts, end))
            r["two_part_ms"], r["two_part_eager_ms"] = cycle(
                lambda lk, lv: two_part(q[:, None], k_new, v_new, lk, lv, end_i, kv_mask))
            r["merge_ms"], r["merge_eager_ms"] = cycle(
                lambda lk, lv: dec.merge_new_token(out, m, l, q, k_new, v_new), 20)
            # the library: a one-token query against the cache rows below `end`,
            # head-major views, a mask where the windows are ragged
            qs = q[:, :, None]
            mask = None if not starts.any() else inside[:, None, None, :end_i]

            def sdpa_call(lk, lv):
                return torch.nn.functional.scaled_dot_product_attention(
                    qs, lk[:, :end_i].transpose(1, 2), lv[:, :end_i].transpose(1, 2),
                    attn_mask=mask, enable_gqa=hq != hkv)
            lib = sdpa_call(ck, cv)[:, :, 0]
            r["library_max_abs_err"] = (lib.float() - w_out.float()).abs().max().item()
            r["library_ms"], r["library_eager_ms"] = cycle(sdpa_call, 20)
            # each K and V row of the windows read once, q read and out, m, l
            # written once; 2 products of D terms per row and query head, in
            # fp32 outside the tensor cores (67 TFLOP/s)
            nbytes = n_rows * hkv * d * 2 * 2 + 2 * b * hq * d * 2 + 2 * b * hq * 4
            t_bytes = nbytes / PEAK_BYTES * 1e3
            t_ops = 4.0 * n_rows * hq * d / 67e12 * 1e3
            r.update(bound_ms=max(t_bytes, t_ops), bytes=nbytes,
                     bound_by="bytes" if t_bytes >= t_ops else "operations")
        if name == "path":
            short = (end - DECODE_SHORT).expand(b).contiguous()
            r["short_ms"], _ = cycle(
                lambda lk, lv: dec.decode_attention(q, lk, lv, short, end), 20)
            if not r["short_ms"] <= r["ms"]:
                raise RuntimeError(f"decode attention: windows of {DECODE_SHORT} rows took "
                                   f"{r['short_ms']:.4f} ms, full windows {r['ms']:.4f} ms")
        results[name] = r
        timed = ("" if "ms" not in r else
                 f"; device time by graph replay (and call by call, host included): kernel "
                 f"{r['ms'] * 1e3:.1f} ({r['eager_ms'] * 1e3:.1f}) us, plain "
                 f"{r['plain_ms'] * 1e3:.1f} us, eager two_part_cached_attention "
                 f"{r['two_part_ms'] * 1e3:.1f} ({r['two_part_eager_ms'] * 1e3:.1f}) us, SDPA "
                 f"{r['library_ms'] * 1e3:.1f} ({r['library_eager_ms'] * 1e3:.1f}) us "
                 f"(max_abs_err to plain {r['library_max_abs_err']:.3e}), bound "
                 f"{r['bound_ms'] * 1e3:.2f} us ({r['bound_by']}, {r['bytes']} bytes), "
                 f"merge_new_token {r['merge_ms'] * 1e3:.1f} ({r['merge_eager_ms'] * 1e3:.1f}) us" +
                 (f", windows of {DECODE_SHORT} rows {r['short_ms'] * 1e3:.1f} us"
                  if "short_ms" in r else ""))
        phase("kernel", f"decode attention {name}: {r['shape']} ({n_rows} rows): out max_abs_err "
              f"{err:.3e} (atol=rtol={DECODE_TOL}), m / l max rel err {r['m_max_rel_err']:.2e} / "
              f"{r['l_max_rel_err']:.2e} (tol {DECODE_ML_RTOL}), rows outside the windows NaN "
              f"and not read, merged with the current token vs two_part_cached_attention "
              f"{merged_err:.3e}{timed}")
    return results


def run_generation(cfg, device, ids, px_u8, smi, *, label: str, n_llm: int, n_vit: int,
                   bf16_logits=None, **flags) -> dict:
    """Phase 8 for one precision -> launches of the main path's run, times,
    and the kernel path's teacher-forced logits."""
    from aigv_assessor_torch.cli.score import build_serving_model
    from aigv_assessor_torch.core.precision import Precision
    from aigv_assessor_torch.models.generation import GenerationConfig, decode_loop, generate
    from aigv_assessor_torch.models.internlm2 import KVCache
    from aigv_assessor_torch.ops import decode_attention as dec
    from aigv_assessor_torch.ops import flash_attention as fa
    from aigv_assessor_torch.ops import int8_matmul as wo
    from aigv_assessor_torch.ops import kv_quant
    from aigv_assessor_torch.ops.preprocess import resize_normalize

    model = build_serving_model(cfg, device=device, seed=0, **flags)
    lm = model.language_model
    kv_int8, int8 = model.precision.kv_int8, model.precision.int8_weights
    dtype = model.precision.compute_dtype
    batch, seq = ids.shape
    max_len = seq + GEN_TOKENS
    gcfg = GenerationConfig(max_new_tokens=GEN_TOKENS, eos_token_id=-1)  # never stops
    counters = (dec.decode_attention, wo.int8_matmul, wo.int4_matmul, fa.flash_attention_qkv,
                fa.flash_attention)
    with torch.inference_mode():
        pv = resize_normalize(px_u8, size=IMAGE, dtype=dtype)
        generate(model, None, ids, pv, gcfg=GenerationConfig(max_new_tokens=2, eos_token_id=-1),
                 with_motion=True)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        # the main path, every count at 0 just before it
        for c in counters:
            c.launches = 0
        t0 = time.perf_counter()
        tokens = generate(model, None, ids, pv, gcfg=gcfg, with_motion=True)
        total_ms = (time.perf_counter() - t0) * 1e3
        counts = {c.__name__: c.launches for c in counters}
        peak_gib = torch.cuda.max_memory_allocated(device) / 2**30
    steps = GEN_TOKENS - 1
    per_pass = 5 * n_llm + 1  # the projections and the LM head
    want = {"decode_attention": 0 if kv_int8 else n_llm * steps,
            "int8_matmul": per_pass * (1 + steps) if int8 else 0, "int4_matmul": 0,
            "flash_attention_qkv": n_vit, "flash_attention": 0}
    if counts != want:
        raise RuntimeError(f"generation {label}: launches {counts}, expected {want}")
    if tokens.shape != (batch, GEN_TOKENS) or tokens.min() < 0 or tokens.max() >= cfg.llm.vocab_size:
        raise RuntimeError(f"generation {label}: token ids {tokens.shape} out of range")

    def new_cache(m):
        # in the model's dtype, which is generate()'s bf16 for the served model
        return KVCache.init(cfg.llm, batch, max_len, dtype=m.precision.compute_dtype,
                            quantized=m.precision.kv_int8, device=device)

    forced = torch.as_tensor(np.random.default_rng(1).integers(10, cfg.llm.vocab_size,
                                                               (batch, FORCED)), device=device)

    def forced_logits(m, embeds):
        """Prefill, then FORCED decode steps on fixed tokens -> logits
        [B, 1 + FORCED, V] fp32 (the prompt's last position and each step) and
        the cache."""
        logits, _, cache = m.prefill(embeds, new_cache(m))
        rows = [logits[:, -1].float()]
        del logits
        for i in range(FORCED):
            logits, _, cache = m.decode_step(forced[:, i : i + 1], cache)
            rows.append(logits[:, -1].float())
        return torch.stack(rows, dim=1), cache

    with torch.inference_mode():
        embeds = model.embed_multimodal(ids, pv, with_motion=True)
        # times: the prefill, and decode steps enqueued back to back
        prefill_ms = time_ms(lambda: model.prefill(embeds, new_cache(model)), 2, warmup=1)
        _, _, cache = model.prefill(embeds, new_cache(model))
        first = torch.zeros(batch, dtype=torch.int64, device=device)
        start_pos = torch.full((batch,), seq, dtype=torch.int64, device=device)
        kv_mask = torch.ones((batch, max_len), dtype=torch.bool, device=device)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        decode_loop(model, first, cache, start_pos, kv_mask, gcfg)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3 / steps
        del cache

        before = dec.decode_attention.launches
        k_logits, k_cache = forced_logits(model, embeds)
        if dec.decode_attention.launches - before != (0 if kv_int8 else n_llm * FORCED):
            raise RuntimeError(f"generation {label}: the forced steps did not go through the "
                               "decode-attention kernel once per layer")
        kernel, launched = dec.decode_attention, dec.decode_attention.launches
        with mock.patch.object(dec, "decode_attention", dec.plain_decode_attention):
            p_logits, _ = forced_logits(model, embeds)
            if kernel.launches != launched:
                raise RuntimeError("the plain decode path launched the kernel")
            r_logits = None
            if bf16_logits is None and not int8:  # the bf16 phase: an fp32 run of the same weights
                ref = copy.deepcopy(model).float()
                ref.precision = ref.language_model.precision = Precision.fp32()
                r_logits, _ = forced_logits(ref, embeds.float())
                del ref
        # the cache-free forward over prompt + forced tokens, with its k/v rows
        all_embeds = torch.cat([embeds, model.embed_tokens(forced)], dim=1)
        _, hidden, captured = lm(inputs_embeds=all_embeds, with_logits=False, capture_kv=True,
                                 rope_len=max_len)
        f_logits = lm.output(hidden[:, seq - 1 :]).float()
        del hidden, all_embeds
        n = seq + FORCED
        got_k, got_v = k_cache.k, k_cache.v
        if kv_int8:
            got_k, got_v = (kv_quant.dequantize_kv_rows(q8[:, :, :n], sc[:, :, :n])
                            for q8, sc in (got_k, got_v))
        rows_rel = max(relative_l2(got_k[:, :, :n].float(), captured.k.float()),
                       relative_l2(got_v[:, :, :n].float(), captured.v.float()))
        rows0_rel = max(relative_l2(got_k[0, :, :n].float(), captured.k[0].float()),
                        relative_l2(got_v[0, :, :n].float(), captured.v[0].float()))
        del captured, k_cache, got_k, got_v

    if not torch.isfinite(k_logits).all():
        raise RuntimeError(f"generation {label}: logits not finite")
    rel_plain, rel_free = relative_l2(k_logits, p_logits), relative_l2(k_logits, f_logits)
    # the cache-free forward attends unrounded rows, an int8 cache rounded ones
    free_tol = KV_INT8_LOGITS_TOL if kv_int8 else DECODE_LOGITS_TOL
    if not (rel_plain <= DECODE_LOGITS_TOL and rel_free <= free_tol):
        raise RuntimeError(f"generation {label}: forced logits relative L2 kernel vs plain path "
                           f"{rel_plain} (tol {DECODE_LOGITS_TOL}), vs the cache-free forward "
                           f"{rel_free} (tol {free_tol})")
    ref_text = ""
    if r_logits is not None:
        rel_kr, rel_pr = relative_l2(k_logits, r_logits), relative_l2(p_logits, r_logits)
        if not rel_kr <= REF_RATIO * rel_pr:
            raise RuntimeError(f"generation {label}: kernel path {rel_kr} from the fp32 "
                               f"reference, plain path {rel_pr}: more than {REF_RATIO}x farther")
        ref_text = f", vs fp32 reference: kernel {rel_kr:.3e}, plain {rel_pr:.3e} (tol {REF_RATIO}x)"
    if bf16_logits is not None and kv_int8:
        rel_q = relative_l2(k_logits, bf16_logits)
        if not rel_q <= KV_INT8_LOGITS_TOL:
            raise RuntimeError(f"generation {label}: logits {rel_q} from the bf16 cache's, above "
                               f"{KV_INT8_LOGITS_TOL}")
        ref_text = f", vs the bf16 cache's logits {rel_q:.3e} (tol {KV_INT8_LOGITS_TOL})"
    # Greedy tokens: nearly flat logits on random weights, so an argmax may
    # flip between two right paths; held only where the plain path's top-two
    # margin exceeds twice the largest difference measured
    top2 = p_logits.topk(2, dim=-1).values
    margin = top2[..., 0] - top2[..., 1]
    agree = k_logits.argmax(-1) == p_logits.argmax(-1)
    clear = margin > 2 * (k_logits - p_logits).abs().max()
    if not agree[clear].all():
        raise RuntimeError(f"generation {label}: an argmax differs where the margin is clear")
    # layer 0's rows come from the same products: rope layout and, for k, the
    # same rounding; every layer within the tolerance of two bf16 forwards
    row_tol = KV_INT8_LOGITS_TOL if kv_int8 else READOUT_TOL
    if not (rows_rel <= row_tol and rows0_rel <= (row_tol if kv_int8 else 2.0**-8)):
        raise RuntimeError(f"generation {label}: cache rows vs capture_kv rows: relative L2 "
                           f"{rows_rel} over all layers, {rows0_rel} in layer 0")
    kv_bytes = 2 * n_llm * batch * max_len * cfg.llm.num_key_value_heads * cfg.llm.head_dim
    cache_bytes = kv_bytes * 2 if not kv_int8 else kv_bytes + kv_bytes // cfg.llm.head_dim * 4
    phase("slice", f"generation {label} InternVL2-2B, {batch} x {seq}-token prompt with motion, "
          f"{GEN_TOKENS} new tokens greedy: launches {counts} ({n_llm} decode attention per "
          f"step); generate {total_ms:.1f} ms; prefill {prefill_ms:.1f} ms, decode step "
          f"{step_ms:.3f} ms, {batch * 1e3 / step_ms:.1f} tokens/s; cache {cache_bytes} bytes "
          f"for {max_len} rows; peak {peak_gib:.2f} GiB allocated; forced logits rel L2 kernel "
          f"vs plain decode attention {rel_plain:.3e}, vs cache-free forward {rel_free:.3e} "
          f"(tol {DECODE_LOGITS_TOL}, cache-free {free_tol}){ref_text}; argmax agrees on {int(agree.sum())} of "
          f"{agree.numel()} ({int(clear.sum())} with a clear margin, all agree); cache rows vs "
          f"capture_kv rows rel L2 {rows_rel:.3e}, layer 0 {rows0_rel:.3e}; tokens of sample 0 "
          f"{tokens[0, :8].tolist()} [{smi}]")
    del model
    torch.cuda.empty_cache()
    return dict(counts=counts, prefill_ms=prefill_ms, step_ms=step_ms, total_ms=total_ms,
                peak_gib=peak_gib, cache_bytes=cache_bytes, logits=k_logits)


def run_shared_prefix(cfg, device, videos, rng, smi, *, n_vit: int, n_llm: int) -> dict:
    """Phase 9: P prompts per video through `score_chunks`, with and without
    the shared prefix."""
    from aigv_assessor_torch.cli.score import (
        build_serving_model, compute_shared_prefix_len, score_chunks)
    from aigv_assessor_torch.core.precision import Precision
    from aigv_assessor_torch.ops import decode_attention as dec
    from aigv_assessor_torch.ops import flash_attention as fa
    from aigv_assessor_torch.ops.preprocess import resize_normalize

    n_ctx = FRAMES * cfg.num_image_token + 1
    seq = n_ctx + TEXT
    prefix = seq - SUFFIX
    ids_pn = rng.integers(10, cfg.llm.vocab_size, (PERSPECTIVES, seq))
    ids_pn[:, :prefix] = ids_pn[0, :prefix]
    ids_pn[:, 1 : 1 + n_ctx] = CTX
    ids_pn[:, prefix] = 10 + np.arange(PERSPECTIVES)  # the questions differ from their first token
    mask_pn = np.ones((PERSPECTIVES, seq), bool)
    mask_pn[-1, -5:] = False  # one shorter question, right-padded
    ids_pn[-1, -5:] = cfg.llm.pad_token_id
    prompts = [ids_pn[i, : mask_pn[i].sum()] for i in range(PERSPECTIVES)]
    if compute_shared_prefix_len(prompts, CTX) != prefix:
        raise RuntimeError("the synthetic prompts do not share the expected prefix")
    chunks = [list(videos[i : i + BATCH]) for i in range(0, len(videos), BATCH)]

    model = build_serving_model(cfg, device=device, seed=0)
    with torch.no_grad():  # the head ends in a ReLU: keep it open, as in training
        getattr(model.mlpscore, f"fc{model.mlpscore.num_layers}").weight.abs_()
    readouts = []
    hook = model.mlpscore.register_forward_hook(
        lambda _m, args, _out: readouts.append(args[0].detach().float().reshape(
            -1, PERSPECTIVES, args[0].shape[-1])))
    counters = (fa.flash_attention_qkv, fa.flash_attention, dec.decode_attention)
    out = {}
    for shared in (True, False):
        score_chunks(model, chunks[:1], ids_pn, mask_pn, batch_size=BATCH,
                     shared_prefix=shared)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        readouts.clear()
        for c in counters:
            c.launches = 0
        t0 = time.perf_counter()
        rows = score_chunks(model, chunks, ids_pn, mask_pn, batch_size=BATCH,
                            shared_prefix=shared)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / len(chunks)
        counts = {c.__name__: c.launches for c in counters}
        want = {"flash_attention_qkv": (n_vit + n_llm) * len(chunks), "flash_attention": 0,
                "decode_attention": 0}
        if counts != want:
            raise RuntimeError(f"shared_prefix={shared}: launches {counts}, expected {want}")
        arr = np.asarray(rows)
        if arr.shape != (len(videos), PERSPECTIVES) or not np.isfinite(arr).all():
            raise RuntimeError(f"shared_prefix={shared}: score rows {arr.shape} not finite")
        out[shared] = dict(ms=ms, peak_gib=torch.cuda.max_memory_allocated(device) / 2**30,
                           scores=arr, readout=torch.cat(readouts), counts=counts)
    hook.remove()
    rs, ru = out[True]["readout"], out[False]["readout"]
    rel = relative_l2(rs, ru)
    score_err = float(np.abs(out[True]["scores"] - out[False]["scores"]).max()
                      / np.abs(out[False]["scores"]).max())
    if not (rel <= READOUT_TOL and score_err <= SCORE_TOL):
        raise RuntimeError(f"shared prefix: readouts {rel} apart (tol {READOUT_TOL}), scores "
                           f"{score_err} (tol {SCORE_TOL})")
    if not np.abs(out[True]["scores"]).max() > 0:
        raise RuntimeError("shared prefix: every score is 0, the comparison saw nothing")
    # the first chunk's first video in fp32 through the plain attention,
    # unshared: the reference both bf16 paths are measured against
    ref = copy.deepcopy(model).float()
    ref.precision = ref.language_model.precision = Precision.fp32()
    ref_rows = []
    ref.mlpscore.register_forward_hook(lambda _m, args, _out: ref_rows.append(args[0].float()))
    with torch.inference_mode(), mock.patch.object(fa, "flash_attention_qkv",
                                                   fa.plain_attention_qkv):
        pv = resize_normalize(torch.as_tensor(videos[:1], device=device), size=IMAGE,
                              dtype=torch.float32)
        ref.score_perspectives(torch.as_tensor(ids_pn[None], device=device), pv,
                               torch.as_tensor(mask_pn[None], device=device))
    del ref
    r = ref_rows[0].reshape(1, PERSPECTIVES, -1)
    rel_sr, rel_ur = relative_l2(rs[:1], r), relative_l2(ru[:1], r)
    if not rel_sr <= REF_RATIO * rel_ur:
        raise RuntimeError(f"shared prefix: shared path {rel_sr} from the fp32 reference, "
                           f"unshared {rel_ur}: more than {REF_RATIO}x farther")
    s, u = out[True], out[False]
    phase("slice", f"shared prefix bf16 InternVL2-2B, {PERSPECTIVES} prompts of {seq} tokens "
          f"sharing {prefix}, {len(chunks)} chunks x {BATCH} videos: shared {s['ms']:.1f} "
          f"ms/chunk, peak {s['peak_gib']:.2f} GiB; unshared ({BATCH * PERSPECTIVES} full "
          f"sequences) {u['ms']:.1f} ms/chunk, peak {u['peak_gib']:.2f} GiB; launches per chunk "
          f"{ {k: v // len(chunks) for k, v in s['counts'].items()} } both ways; readouts rel "
          f"L2 shared vs unshared {rel:.3e} (tol {READOUT_TOL}), vs fp32 reference: shared "
          f"{rel_sr:.3e}, unshared {rel_ur:.3e} (tol {REF_RATIO}x); max score difference over the "
          f"largest score {score_err:.3e} (tol {SCORE_TOL}); scores of video 0 shared "
          f"{np.round(s['scores'][0], 3).tolist()} unshared {np.round(u['scores'][0], 3).tolist()} "
          f"[{smi}]")
    del model
    torch.cuda.empty_cache()
    return out


def write_cli_videos(folder: str) -> None:
    """CLI_VIDEOS mp4 files of CLI_FRAMES frames at CLI_SIZE, and one GIF."""
    import cv2
    from PIL import Image

    rng = np.random.default_rng(3)
    w, h = CLI_SIZE
    for i in range(CLI_VIDEOS):
        writer = cv2.VideoWriter(os.path.join(folder, f"video{i}.mp4"),
                                 cv2.VideoWriter_fourcc(*"mp4v"), 30, (w, h))
        if not writer.isOpened():
            raise RuntimeError("cv2.VideoWriter cannot write mp4v here")
        base = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        for t in range(CLI_FRAMES):  # a moving picture: the frame rolls right
            writer.write(np.roll(base, 8 * t, axis=1))
        writer.release()
    frames = [Image.fromarray(rng.integers(0, 256, (240, 320, 3), dtype=np.uint8))
              for _ in range(12)]
    frames[0].save(os.path.join(folder, "clip.gif"), save_all=True, append_images=frames[1:],
                   duration=100)


def run_score_cli(device, smi, *, n_llm: int) -> None:
    """Phase 10: `cli/score.main` on video files, 2B, W8A8 with every feed
    fused."""
    from aigv_assessor_torch.cli import score
    from aigv_assessor_torch.data import native_decode
    from aigv_assessor_torch.data.tokenizer import build_test_tokenizer
    from aigv_assessor_torch.data.video import frames_to_uint8, load_video
    from aigv_assessor_torch.ops import flash_attention as fa
    from aigv_assessor_torch.ops import quant_fuse as qf

    counters = (qf.rmsnorm_quant, qf.silu_mul_quant, qf.quant_rows, qf.layernorm_quant,
                qf.gelu_quant, fa.flash_attention_qkv)
    questions = ["How would you rate the static quality of this video?",
                 "How would you rate the temporal smoothness of this video?"]
    env = {**os.environ, "AIGV_FUSE_QUANT": "vit,llm", "AIGV_QUANT_ROWS": "vit,llm"}
    with tempfile.TemporaryDirectory() as d:
        write_cli_videos(d)
        out = os.path.join(d, "scores.csv")
        argv = ["--videos", d, "--model_scale", "2b", "--w8a8", "True", "--batch_size",
                str(BATCH), "--num_segments", str(FRAMES), "--out", out,
                "--device", str(device), *[a for q in questions for a in ("--question", q)]]
        for c in counters:
            c.launches = 0
        stdout = io.StringIO()
        t0 = time.perf_counter()
        # the switches are read once, from os.environ, by cli/common.py
        with mock.patch.object(os, "environ", env), contextlib.redirect_stdout(stdout):
            score.main(argv)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        counts = {c.__name__: c.launches for c in counters}
        summary = json.loads(stdout.getvalue().strip().splitlines()[-1])
        with open(out) as f:
            table = list(csv.reader(f))
        # the host side alone, one video at a time: decode as the CLI's
        # workers do it, and the tokenizer's prompt
        decode_ms = {}
        for path in score.list_videos(d):
            t0 = time.perf_counter()
            frames = load_video(path, num_segments=FRAMES, out_size=IMAGE)
            frames_to_uint8(frames, input_size=IMAGE)
            decode_ms[os.path.basename(path)] = (time.perf_counter() - t0) * 1e3
        tok = build_test_tokenizer()
        t0 = time.perf_counter()
        score.build_prompt_ids(tok, "internlm2-chat", questions[0], FRAMES, 256)
        prompt_ms = (time.perf_counter() - t0) * 1e3
    n_videos = CLI_VIDEOS + 1
    rows = np.asarray([[float(v) for v in r[1:]] for r in table[1:]])
    if (table[0] != ["video_name", "pred_score_1", "pred_score_2"]
            or rows.shape != (n_videos, 2) or not np.isfinite(rows).all()):
        raise RuntimeError(f"CLI: CSV header {table[0]}, scores {rows.shape}, not {n_videos} "
                           "rows of 2 finite scores")
    if summary.get("n_videos") != n_videos or summary.get("n_perspectives") != 2:
        raise RuntimeError(f"CLI: summary line {summary}")
    # each chunk: the shared prefix's cache-free pass and the questions' pass
    # over its cache, each 2 K5a and 1 K5b per decoder layer
    chunks = -(-n_videos // BATCH)
    want = {"rmsnorm_quant": chunks * 2 * 2 * n_llm, "silu_mul_quant": chunks * 2 * n_llm}
    if {k: counts[k] for k in want} != want:
        raise RuntimeError(f"CLI: launches {counts}, expected {want}")
    decoder = ("native libvideodec.so (mp4), PIL (GIF)" if native_decode.available()
               else "OpenCV (mp4; native libvideodec.so did not load), PIL (GIF)")
    phase("cli", f"cli.score.main --model_scale 2b --w8a8 True, AIGV_FUSE_QUANT = "
          f"AIGV_QUANT_ROWS = vit,llm, {len(questions)} questions on the shared prefix, batch "
          f"{BATCH}, {FRAMES} frames: {CLI_VIDEOS} mp4 ({CLI_FRAMES} frames, {CLI_SIZE[0]}x"
          f"{CLI_SIZE[1]}) + 1 GIF -> {n_videos} CSV rows of 2 finite scores; decoder "
          f"{decoder}; {summary['value']} videos/s with decode included (the CLI's own line, "
          f"model build excluded), {wall_s:.1f} s for the whole call with the 2B model's build; "
          f"host side alone, one video at a time: decode to {FRAMES} frames of {IMAGE} px "
          f"{np.mean([v for k, v in decode_ms.items() if k.endswith('.mp4')]):.1f} ms per mp4, "
          f"{decode_ms['clip.gif']:.1f} ms for the GIF, prompt tokenization {prompt_ms:.2f} ms; "
          f"launches {counts} over {chunks} chunks; scores of the first video "
          f"{np.round(rows[0], 3).tolist()} [{smi}]")


# ------------------------------------------- K2's training forms (three tensors) --


def separate_inputs(name: str, shape, device):
    """q, k, v and dout for one SEPARATE_TRAIN shape, as its caller hands
    them over."""
    from aigv_assessor_torch.ops.norms import rms_norm

    b, sq, skv, hq, hkv, d, causal, kv_valid, layout = shape
    gen = torch.Generator(device=device).manual_seed(20)
    if name.startswith("vit"):
        # the QK-normalized ViT: q and k from the norms over the flattened C
        # (contiguous), v a strided view of the [B, N, 3C] projection; the
        # pad rows' k and v hold garbage, and carry no gradient
        c = hq * d
        proj = torch.randn((b, sq, 3 * c), generator=gen, device=device).to(torch.bfloat16)
        proj[:, kv_valid:, c:] = 1e3
        q, k, v = proj.split(c, dim=-1)
        ones = torch.ones(c, device=device)
        q, k = (rms_norm(t, ones).view(b, sq, hq, d) for t in (q, k))
        v = v.view(b, sq, hq, d)
    elif name.startswith("llm"):
        # the decoder's row-major branch: [B, S, H, D] views of one projection
        proj = torch.randn((b, sq, (hq + 2 * hkv) * d), generator=gen, device=device)
        proj = proj.to(torch.bfloat16)
        q = proj[..., : hq * d].view(b, sq, hq, d)
        k = proj[..., hq * d : (hq + hkv) * d].view(b, sq, hkv, d)
        v = proj[..., (hq + hkv) * d :].view(b, sq, hkv, d)
    else:
        q = torch.randn((b, hq, sq, d), generator=gen, device=device)
        k, v = (torch.randn((b, hkv, skv, d), generator=gen, device=device) for _ in range(2))
        if kv_valid is not None:
            k[:, :, kv_valid:], v[:, :, kv_valid:] = 1e3, -1e3
        q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
    dout = torch.randn(q.shape, generator=gen, device=device)
    if name.startswith("vit"):
        dout[:, kv_valid:] = 0.0
    return q, k, v, dout.to(torch.bfloat16)


def separate_work(shape) -> dict:
    """FLOPs and bytes of the attention kernels at one shape, from what this
    run's masks leave: Sq * kv_valid (query, key) pairs, or the causal
    triangle. Products per pair and head dim element: forward 2 (QK^T, PV),
    dq 3 (QK^T, dO V^T, dS K), dk/dv 4 (QK^T, dO V^T, P^T dO, dS^T Q). Bytes:
    each input read once, each output written once."""
    b, sq, skv, hq, hkv, d, causal, kv_valid, _ = shape
    pairs = sq * (sq + 1) // 2 if causal else sq * (kv_valid or skv)
    per_product = 2 * b * hq * pairs * d
    q_bytes, kv_bytes, stat = b * hq * sq * d * 2, b * hkv * skv * d * 2, b * hq * sq * 4
    qkv = q_bytes + 2 * kv_bytes
    return {
        "fwd": (2 * per_product, qkv + q_bytes),
        "fwd_lse": (2 * per_product, qkv + q_bytes + stat),
        "dq": (3 * per_product, qkv + q_bytes + 2 * stat + q_bytes),
        "dkv": (4 * per_product, qkv + q_bytes + 2 * stat + 2 * kv_bytes),
    }


def check_attention_separate_training(fa, device, shapes) -> dict:
    """K2's forward with logsumexp and its dq and dk/dv kernels against the
    plain versions, timed by CUDA graph replay, beside the bound, the plain
    versions and SDPA."""
    results = {}
    for name, shape in shapes.items():
        b, sq, skv, hq, hkv, d, causal, kv_valid, layout = shape
        q, k, v, dout = separate_inputs(name, shape, device)
        kw = dict(causal=causal, layout=layout, kv_valid=kv_valid)
        out, lse = fa.flash_attention_lse(q, k, v, **kw)
        no_lse = fa.flash_attention(q, k, v, **kw)
        dq, dk, dv = fa.flash_attention_bwd(q, k, v, out, lse, dout, **kw)
        torch.cuda.synchronize()
        if not torch.equal(out, no_lse):
            raise RuntimeError(f"K2 {name}: out with logsumexp differs from out without")
        _, plain_lse = fa.plain_flash_attention(q, k, v, return_lse=True, **kw)
        lse_err = (lse - plain_lse).abs().max().item()
        if not (torch.isfinite(lse).all() and lse_err <= LSE_TOL):
            raise RuntimeError(f"K2 {name}: logsumexp max abs err {lse_err} above {LSE_TOL}")
        want = fa.plain_flash_attention_bwd(q, k, v, out, lse, dout, **kw)
        got = {"dq": dq, "dk": dk, "dv": dv}
        if not all(torch.isfinite(t).all() for t in got.values()):
            raise RuntimeError(f"K2 {name}: a gradient is not finite")
        rel = {n: relative_l2(t.float(), w.float()) for (n, t), w in zip(got.items(), want)}
        err = {n: (t.float() - w.float()).abs().max().item()
               for (n, t), w in zip(got.items(), want)}
        if not all(r <= BWD_TOL for r in rel.values()):
            raise RuntimeError(f"K2 {name}: backward relative L2 {rel} above {BWD_TOL}")
        seq = 2 if layout == "bhsd" else 1
        if kv_valid is not None and (dk.narrow(seq, kv_valid, skv - kv_valid).any()
                                     or dv.narrow(seq, kv_valid, skv - kv_valid).any()):
            raise RuntimeError(f"K2 {name}: dk/dv rows of masked keys are not exactly 0")
        del want, plain_lse

        delta = (dout.float() * out.float()).sum(-1)
        delta = (delta if layout == "bhsd" else delta.transpose(1, 2)).contiguous()
        ms_lse = graph_ms([lambda: fa.flash_attention_lse(q, k, v, **kw)] * 3, 5)
        ms_dq = graph_ms([lambda: fa.flash_attention_bwd_dq(q, k, v, dout, lse, delta, dq, **kw)]
                         * 3, 5)
        ms_dkv = graph_ms([lambda: fa.flash_attention_bwd_dkv(q, k, v, dout, lse, delta, dk, dv,
                                                              **kw)] * 3, 5)
        plain_lse_ms = time_ms(
            lambda: fa.plain_flash_attention(q, k, v, return_lse=True, **kw), 3, warmup=1)
        plain_bwd_ms = time_ms(
            lambda: fa.plain_flash_attention_bwd(q, k, v, out, lse, dout, **kw), 3, warmup=1)
        # the library takes head-major views, k and v cut at kv_valid
        hm = (lambda t: t) if layout == "bhsd" else (lambda t: t.transpose(1, 2))
        qs, ks, vs = hm(q), hm(k)[:, :, :kv_valid], hm(v)[:, :, :kv_valid]
        dos = hm(dout)
        lib_shape = (b, hq, hkv, sq, d, causal, kv_valid)
        with torch.no_grad():
            library_ms = time_ms(lambda: sdpa(qs, ks, vs, lib_shape), 10)
        qg, kg, vg = (t.detach().requires_grad_() for t in (qs, ks, vs))

        def fwd_bwd():
            torch.autograd.grad(sdpa(qg, kg, vg, lib_shape), (qg, kg, vg), dos)

        library_fwd_bwd_ms = time_ms(fwd_bwd, 10)
        work = separate_work(shape)
        bounds = {n: bound_ms(*work[n]) for n in ("fwd_lse", "dq", "dkv")}
        text = (f"{layout} B={b} Sq={sq} Skv={skv} hq={hq} hkv={hkv} D={d} causal={causal} "
                f"kv_valid={kv_valid}")
        results[name] = dict(
            shape=text, lse_max_abs_err=lse_err, rel_l2=rel, max_abs_err=err,
            lse_ms=ms_lse, dq_ms=ms_dq, dkv_ms=ms_dkv, plain_lse_ms=plain_lse_ms,
            plain_bwd_ms=plain_bwd_ms, library_ms=library_ms,
            library_fwd_bwd_ms=library_fwd_bwd_ms,
            bounds={n: dict(bound_ms=v[0], bound_by=v[1]) for n, v in bounds.items()})
        phase("kernel", f"K2 training {name}: {text}: out bit-equal with and without lse, lse "
              f"max_abs_err {lse_err:.3e} (tol {LSE_TOL}); rel L2 dq {rel['dq']:.3e} dk "
              f"{rel['dk']:.3e} dv {rel['dv']:.3e} (tol {BWD_TOL}), masked-key rows exactly 0; "
              f"by graph replay fwd+lse {ms_lse:.4f} ms (bound {bounds['fwd_lse'][0]:.4f}, "
              f"plain {plain_lse_ms:.4f}, SDPA fwd {library_ms:.4f}), dq {ms_dq:.4f} ms (bound "
              f"{bounds['dq'][0]:.4f}), dk/dv {ms_dkv:.4f} ms (bound {bounds['dkv'][0]:.4f}), "
              f"plain backward {plain_bwd_ms:.4f} ms, SDPA fwd+bwd {library_fwd_bwd_ms:.4f} ms")
        del q, k, v, dout, out, lse, dq, dk, dv, delta, qg, kg, vg
        torch.cuda.empty_cache()
    return results


# ---------------------------------------------------- stage 1 on InternVL2-2B --


STAGE1_ANSWER = "The static quality of the video is good."


def stage1_batch(cfg, px_u8):
    """A stage-1 batch: the prompt through the port's template and test
    tokenizer, labels from `preprocess_internlm` (only the answer counts)."""
    from aigv_assessor_torch.data.preprocess import preprocess_internlm
    from aigv_assessor_torch.data.tokenizer import build_test_tokenizer

    tokenizer = build_test_tokenizer()
    blocks = "\n".join(f"Frame{i + 1}: <image>" for i in range(FRAMES))
    question = blocks + "\nMotion Feature: <image>\nHow would you rate the static quality of this video?"
    source = [{"from": "human", "value": question}, {"from": "gpt", "value": STAGE1_ANSWER}]
    # no padding (group_by_length): every sample has the same length
    (sample,) = preprocess_internlm(cfg.template, [source], tokenizer,
                                    [cfg.num_image_token] * FRAMES + [1], group_by_length=True)
    answer = tokenizer.decode([int(t) for t in sample.input_ids[sample.labels != -100]])
    if sample.mismatch or not answer.startswith(STAGE1_ANSWER):
        raise RuntimeError(f"stage 1: labels cover {answer!r}, not the answer")
    if int((sample.input_ids == tokenizer.img_context_token_id).sum()) != (
            FRAMES * cfg.num_image_token + 1):
        raise RuntimeError("stage 1: the prompt lost <IMG_CONTEXT> slots")
    n = px_u8.shape[0]

    def rows(a):
        return torch.as_tensor(np.tile(a[None], (n, 1)))

    return {"input_ids": rows(sample.input_ids.astype(np.int64)),
            "labels": rows(sample.labels.astype(np.int64)),
            "attention_mask": rows(sample.attention_mask), "pixels_u8": px_u8}, int(
                tokenizer.img_context_token_id)


def run_stage1_slice(device, px_u8, n_vit: int, n_llm: int, smi: str) -> dict:
    """Stage 1 at InternVL2-2B: TRAIN_STEPS steps through
    `cli/stage1_train.train_steps` -> launches over the steps."""
    from aigv_assessor_torch.cli import stage1_train
    from aigv_assessor_torch.core.config import LLM_2B, AssessorConfig
    from aigv_assessor_torch.ops import flash_attention as fa
    from aigv_assessor_torch.train.trainer import TrainConfig

    cfg = AssessorConfig(llm=LLM_2B, stage=1)
    batch, ctx_id = stage1_batch(cfg, px_u8)
    cfg = cfg.replace(img_context_token_id=ctx_id)
    seq = batch["input_ids"].shape[1]
    with tempfile.TemporaryDirectory() as out_dir:
        tc = TrainConfig(output_dir=out_dir, learning_rate=TRAIN_LR, warmup_ratio=0.0,
                         lr_scheduler_type="constant", num_train_epochs=1, save_steps=0,
                         seed=0, freeze_backbone=True, freeze_llm=True, freeze_mlp=False)
        t0 = time.perf_counter()
        model = stage1_train.build_training_model(cfg, device=device, seed=0, train_config=tc)
        trainer = stage1_train.Trainer(model, tc, TRAIN_STEPS)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        trained = set(trainer.trainable)
        if {n.split(".", 1)[0] for n in trained} != {"mlp1", "motion_mlp"}:
            raise RuntimeError(f"stage 1: trainable {sorted(trained)[:5]}..., expected mlp1 and "
                               "motion_mlp")
        weights = torch.cuda.memory_allocated(device) / 2**30
        before = {n: t.detach().clone() for n, t in model.state_dict().items()}
        prepared = stage1_train.prepare_batch(model, batch["input_ids"], batch["pixels_u8"],
                                              batch["attention_mask"], batch["labels"])

        def eval_loss() -> float:
            model.eval()
            with torch.no_grad():
                return model(prepared["input_ids"], prepared["pixel_values"],
                             prepared["attention_mask"], labels=prepared["labels"])["loss"].item()

        loss_before = eval_loss()
        torch.cuda.reset_peak_memory_stats(device)
        for c in training_counters(fa):
            c.launches = 0
        t0 = time.perf_counter()
        stage1_train.train_steps(model, [batch] * TRAIN_STEPS, tc, trainer=trainer)
        torch.cuda.synchronize()
        total_ms = (time.perf_counter() - t0) * 1e3
        counts = {c.__name__: c.launches for c in training_counters(fa)}
        peak = torch.cuda.max_memory_allocated(device) / 2**30
        with open(f"{out_dir}/train_log.jsonl") as f:
            log = [json.loads(line) for line in f]
        artifact = os.path.getsize(f"{out_dir}/{stage1_train.TRAINABLE_FILE}")
    losses = [r["loss"] for r in log]
    steady_ms = (log[-1]["time"] - log[-2]["time"]) * 1e3
    per_step = {"flash_attention_qkv": n_vit, "flash_attention_qkv_lse": 2 * n_llm,
                "flash_attention_qkv_bwd_dq": n_llm, "flash_attention_qkv_bwd_dkv": n_llm}
    want = {n: per_step.get(n, 0) * TRAIN_STEPS for n in counts}
    if counts != want:
        raise RuntimeError(f"stage 1: launches {counts} for {TRAIN_STEPS} steps, expected {want}")
    if len(losses) != TRAIN_STEPS or not np.isfinite(losses).all():
        raise RuntimeError(f"stage 1: losses {losses}")
    state = model.state_dict()
    changed = sorted(n for n in state if not torch.equal(state[n], before[n]))
    frozen_changed = [n for n in changed if n not in trained]
    if frozen_changed:
        raise RuntimeError(f"stage 1: frozen tensors changed: {frozen_changed[:5]}")
    for top in ("mlp1", "motion_mlp"):
        if not any(n.startswith(top + ".") for n in changed):
            raise RuntimeError(f"stage 1: {top} did not move")
    loss_after = eval_loss()
    if not loss_after < loss_before:
        raise RuntimeError(f"stage 1: dropout-off loss {loss_before} before, {loss_after} after "
                           f"{TRAIN_STEPS} steps at lr {TRAIN_LR}")
    n_labels = int((batch["labels"][0, 1:] != -100).sum())
    phase("slice", f"stage 1 InternVL2-2B through cli/stage1_train.train_steps: "
          f"{px_u8.shape[0]} videos x {px_u8.shape[1]} frames {px_u8.shape[2]}px, seq {seq} "
          f"(test tokenizer, no padding), {n_labels} label tokens per video ({STAGE1_ANSWER!r} and "
          f"<|im_end|>), bf16 frozen towers, fp32 mlp1 / motion_mlp, checkpointing on, drop "
          f"path {cfg.vision.drop_path_rate}, {TRAIN_STEPS} steps at constant lr {TRAIN_LR}: "
          f"launches per micro-batch { {k: v // TRAIN_STEPS for k, v in counts.items() if v} }; "
          f"{steady_ms:.1f} ms/step (the last), {total_ms / TRAIN_STEPS:.1f} ms/step over the "
          f"call with the {artifact}-byte artifact; peak {peak:.2f} GiB allocated (weights "
          f"{weights:.2f} GiB), init {init_s:.1f} s; losses {np.round(losses, 5).tolist()}, "
          f"dropout-off loss {loss_before:.5f} -> {loss_after:.5f}; towers and SlowFast "
          f"bit-equal, {len(changed)} mlp1 / motion_mlp tensors moved [{smi}]")
    del model, trainer, before, state, prepared
    return dict(counts=counts, ms=steady_ms, peak_gib=peak)


def training_counters(fa):
    """Every attention kernel's wrapper, for launch counts of a training run."""
    return (fa.flash_attention_qkv, fa.flash_attention_qkv_lse, fa.flash_attention_qkv_bwd_dq,
            fa.flash_attention_qkv_bwd_dkv, fa.flash_attention, fa.flash_attention_lse,
            fa.flash_attention_bwd_dq, fa.flash_attention_bwd_dkv)


# --------------------------------------------------------------- InternVL2-26B --

# The published config.json of OpenGVLab/InternVL2-26B (InternViT-6B-448px-V1-5
# with internlm2-chat-20b), as `AssessorConfig.from_dict` reads a checkpoint's.
INTERNVL2_26B = {
    "architectures": ["InternVLChatModel"],
    "downsample_ratio": 0.5,
    "force_image_size": 448,
    "ps_version": "v2",
    "select_layer": -1,
    "template": "internlm2-chat",
    "use_backbone_lora": 0,
    "use_llm_lora": 0,
    "vision_config": {
        "architectures": ["InternVisionModel"], "hidden_size": 3200,
        "intermediate_size": 12800, "num_hidden_layers": 45, "num_attention_heads": 25,
        "image_size": 448, "patch_size": 14, "num_channels": 3, "hidden_act": "gelu",
        "norm_type": "rms_norm", "qk_normalization": True, "qkv_bias": False,
        "layer_norm_eps": 1e-6, "initializer_factor": 0.1, "drop_path_rate": 0.0,
        "dropout": 0.0, "attention_dropout": 0.0, "use_flash_attn": True,
    },
    "llm_config": {
        "architectures": ["InternLM2ForCausalLM"], "hidden_size": 6144,
        "intermediate_size": 16384, "num_hidden_layers": 48, "num_attention_heads": 48,
        "num_key_value_heads": 8, "vocab_size": 92553, "hidden_act": "silu",
        "rms_norm_eps": 1e-5, "rope_theta": 1000000, "max_position_embeddings": 32768,
        "rope_scaling": {"type": "dynamic", "factor": 2.0}, "bias": False,
        "tie_word_embeddings": False, "bos_token_id": 1, "eos_token_id": 2, "pad_token_id": 2,
    },
}
DEPTH_CUT = 2  # layers per tower of the 26B checks against fp32


def internvl2_26b(layers=None, **kw):
    from aigv_assessor_torch.core.config import AssessorConfig

    d = copy.deepcopy(INTERNVL2_26B)
    if layers is not None:
        d["vision_config"]["num_hidden_layers"] = d["llm_config"]["num_hidden_layers"] = layers
    return AssessorConfig.from_dict(d).replace(stage=2, img_context_token_id=CTX, **kw)


def plain_attention_patches(fa):
    """Both attention entry points swapped for their plain versions."""
    stack = contextlib.ExitStack()
    stack.enter_context(mock.patch.object(fa, "flash_attention_qkv", fa.plain_attention_qkv))
    stack.enter_context(mock.patch.object(fa, "flash_attention", fa.plain_flash_attention))
    return stack


def run_26b(device, ids, mask, px_u8, videos, ids_pn, mask_pn, smi) -> dict:
    """The InternVL2-26B phase: checks at full width and DEPTH_CUT layers per
    tower, then scoring a chunk and training TRAIN_STEPS LoRA steps at full
    depth. -> its numbers and launch counts."""
    import gc

    from aigv_assessor_torch.cli.score import build_serving_model, score_batch, score_chunks
    from aigv_assessor_torch.cli.stage2_train import build_training_model, train_steps
    from aigv_assessor_torch.core.precision import Precision
    from aigv_assessor_torch.models.lora import LoRALinear, set_generator
    from aigv_assessor_torch.ops import flash_attention as fa
    from aigv_assessor_torch.ops.preprocess import resize_normalize
    from aigv_assessor_torch.train.trainer import TrainConfig, Trainer

    full = internvl2_26b()
    n_vit, n_llm = full.vision.num_hidden_layers, full.llm.num_hidden_layers
    pv = resize_normalize(px_u8, size=IMAGE, dtype=torch.float32)
    out = {}

    # (a) full width, DEPTH_CUT layers per tower: scoring against the plain
    # path and an fp32 forward
    cut = internvl2_26b(DEPTH_CUT)
    model = build_serving_model(cut, device=device, seed=0)
    ref = copy.deepcopy(model).float()
    ref.precision = Precision.fp32()
    with torch.inference_mode():
        kernel_out = model(ids[:, 0], pv.to(torch.bfloat16), mask[:, 0])
        launched = [c.launches for c in training_counters(fa)]
        with plain_attention_patches(fa):
            plain_out = model(ids[:, 0], pv.to(torch.bfloat16), mask[:, 0])
            ref_out = ref(ids[:, 0], pv, mask[:, 0])
        if [c.launches for c in training_counters(fa)] != launched:
            raise RuntimeError("26B: the plain forwards launched a kernel")
    k_, p_, r_ = (o["readout"].float() for o in (kernel_out, plain_out, ref_out))
    rel_kp, rel_kr, rel_pr = relative_l2(k_, p_), relative_l2(k_, r_), relative_l2(p_, r_)
    if not torch.isfinite(k_).all() or not rel_kp <= READOUT_TOL:
        raise RuntimeError(f"26B x{DEPTH_CUT}: readout kernel vs plain {rel_kp} above {READOUT_TOL}")
    if not rel_kr <= REF_RATIO * rel_pr:
        raise RuntimeError(f"26B x{DEPTH_CUT}: kernel path {rel_kr} from fp32, plain {rel_pr}: "
                           f"more than {REF_RATIO}x farther")
    del model, ref, kernel_out, plain_out, ref_out

    # (a') the adapters' gradients of (readout . u) at the same cut, every
    # adapter live (lora_b drawn small instead of zero)
    lora_kw = dict(use_backbone_lora=LORA_RANK, use_llm_lora=LORA_RANK)
    model = build_training_model(cut.replace(**lora_kw), device=device, seed=0)
    gen = torch.Generator(device=device).manual_seed(8)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, LoRALinear):
                m.lora_b.normal_(0.0, 0.02, generator=gen)
    adapters = [n for n, _ in model.named_parameters() if "lora_" in n]
    for n, p in model.named_parameters():
        p.requires_grad_(n in adapters)
    u = torch.randn((BATCH, full.llm.hidden_size), device=device,
                    generator=torch.Generator(device=device).manual_seed(7))

    def eval_grads(m) -> torch.Tensor:
        m.eval()
        for p in m.parameters():
            p.grad = None
        dtype = m.precision.compute_dtype
        readout = m(ids[:, 0], pv.to(dtype), mask[:, 0])["readout"]
        (readout.float() * u).sum().backward()
        return torch.cat([p.grad.float().flatten() for n, p in m.named_parameters()
                          if n in adapters])

    before = [c.launches for c in training_counters(fa)]
    g_kernel = eval_grads(model)
    grad_launches = [c.launches - b for c, b in zip(training_counters(fa), before)]
    # forward + recompute, one backward: K2 lse, dq, dk/dv and K1 lse, K3a, K3b
    want_launches = [0, 2 * DEPTH_CUT, DEPTH_CUT, DEPTH_CUT, 0, 2 * DEPTH_CUT, DEPTH_CUT,
                     DEPTH_CUT]
    if grad_launches != want_launches:
        raise RuntimeError(f"26B x{DEPTH_CUT}: the backward launched {grad_launches}, "
                           f"expected {want_launches}")
    ref = copy.deepcopy(model).float()
    ref.precision = Precision.fp32()
    launched = [c.launches for c in training_counters(fa)]
    with plain_attention_patches(fa):
        g_plain = eval_grads(model)
        g_ref = eval_grads(ref)
    if [c.launches for c in training_counters(fa)] != launched:
        raise RuntimeError("26B: the plain backwards launched a kernel")
    del ref, model
    gk, gp, gr = relative_l2(g_kernel, g_plain), relative_l2(g_plain, g_ref), relative_l2(
        g_kernel, g_ref)
    if not torch.isfinite(g_kernel).all() or not gk <= TRAIN_GRAD_TOL:
        raise RuntimeError(f"26B x{DEPTH_CUT}: adapter gradients kernel vs plain {gk} above "
                           f"{TRAIN_GRAD_TOL}")
    if not gr <= REF_RATIO * gp:
        raise RuntimeError(f"26B x{DEPTH_CUT}: kernel-path gradient {gr} from fp32, plain {gp}: "
                           f"more than {REF_RATIO}x farther")
    phase("slice", f"InternVL2-26B at full width, {DEPTH_CUT} layers per tower: readout rel L2 "
          f"kernel vs plain {rel_kp:.3e} (tol {READOUT_TOL}), vs fp32: kernel {rel_kr:.3e}, "
          f"plain {rel_pr:.3e} (tol {REF_RATIO}x); adapter gradients of (readout . u) "
          f"({g_kernel.numel()} values, launches {grad_launches}) rel L2 kernel vs plain "
          f"{gk:.3e} (tol {TRAIN_GRAD_TOL}), vs fp32: kernel {gr:.3e}, plain {gp:.3e} (tol "
          f"{REF_RATIO}x) [{smi}]")
    out.update(cut_readout=dict(kernel_plain=rel_kp, kernel_fp32=rel_kr, plain_fp32=rel_pr),
               cut_grads=dict(kernel_plain=gk, kernel_fp32=gr, plain_fp32=gp))
    del g_kernel, g_plain, g_ref
    gc.collect()
    torch.cuda.empty_cache()

    # (b) scoring one chunk at full depth
    t0 = time.perf_counter()
    model = build_serving_model(full, device=device, seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weights = torch.cuda.memory_allocated(device) / 2**30
    n_params = sum(p.numel() for p in model.parameters())
    scores = score_batch(model, ids, px_u8, mask)  # warm-up
    torch.cuda.synchronize()
    if tuple(scores.shape) != (BATCH, 1) or not torch.isfinite(scores).all():
        raise RuntimeError(f"26B: scores {tuple(scores.shape)} not finite [{BATCH}, 1]")
    torch.cuda.reset_peak_memory_stats(device)
    for c in training_counters(fa):
        c.launches = 0
    t0 = time.perf_counter()
    rows = score_chunks(model, [list(videos[:BATCH])], ids_pn, mask_pn, batch_size=BATCH)
    torch.cuda.synchronize()
    chunk_ms = (time.perf_counter() - t0) * 1e3
    score_counts = {c.__name__: c.launches for c in training_counters(fa)}
    peak = torch.cuda.max_memory_allocated(device) / 2**30
    want = {n: 0 for n in score_counts}
    want.update(flash_attention=n_vit, flash_attention_qkv=n_llm)
    if score_counts != want:
        raise RuntimeError(f"26B scoring: launches {score_counts}, expected {want}")
    arr = np.asarray(rows)
    if arr.shape != (BATCH, 1) or not np.isfinite(arr).all():
        raise RuntimeError(f"26B scoring: rows {arr.shape} not finite")
    with torch.inference_mode():
        kernel_out = model(ids[:, 0], pv.to(torch.bfloat16), mask[:, 0])["readout"].float()
        with plain_attention_patches(fa):
            plain_out = model(ids[:, 0], pv.to(torch.bfloat16), mask[:, 0])["readout"].float()
    if not torch.isfinite(kernel_out).all():
        raise RuntimeError("26B scoring: the readout is not finite")
    rel_full = relative_l2(kernel_out, plain_out)
    phase("slice", f"InternVL2-26B stage-2 scoring, full depth ({n_vit} + {n_llm} layers, "
          f"{n_params / 1e9:.2f} G values in bf16), one chunk of {BATCH} videos x {FRAMES} "
          f"frames {IMAGE}px, seq {ids.shape[-1]}: launches per forward "
          f"{ {k: v for k, v in score_counts.items() if v} }, {chunk_ms:.1f} ms/chunk, peak "
          f"{peak:.2f} GiB allocated (weights {weights:.2f} GiB), init {init_s:.1f} s; readout "
          f"rel L2 kernel vs plain {rel_full:.3e}; scores {np.round(arr[:, 0], 4).tolist()} "
          f"[{smi}]")
    out.update(score_counts=score_counts, chunk_ms=chunk_ms, score_peak_gib=peak,
               weights_gib=weights, full_readout_kernel_plain=rel_full)
    del model, kernel_out, plain_out
    gc.collect()
    torch.cuda.empty_cache()

    # (c) TRAIN_STEPS stage-2 LoRA steps at full depth
    lora_cfg = full.replace(**lora_kw)
    lora_cfg = lora_cfg.replace(vision=dataclasses.replace(lora_cfg.vision, drop_path_rate=0.1))
    rng = np.random.default_rng(3)
    batch = {"input_ids": ids[:TRAIN_26B_VIDEOS, 0], "pixels_u8": px_u8[:TRAIN_26B_VIDEOS],
             "attention_mask": mask[:TRAIN_26B_VIDEOS, 0],
             "mos": torch.as_tensor(rng.uniform(20.0, 90.0, TRAIN_26B_VIDEOS),
                                    dtype=torch.float32)}
    with tempfile.TemporaryDirectory() as out_dir:
        tc = TrainConfig(output_dir=out_dir, learning_rate=TRAIN_LR, warmup_ratio=0.0,
                         lr_scheduler_type="constant", num_train_epochs=1, save_steps=0, seed=0)
        t0 = time.perf_counter()
        model = build_training_model(lora_cfg, device=device, seed=0, train_config=tc)
        with torch.no_grad():  # keep the score head's last ReLU open, as phase 7 does
            getattr(model.mlpscore, f"fc{model.mlpscore.num_layers}").weight.abs_()
        trainer = Trainer(model, tc, TRAIN_STEPS)
        torch.cuda.synchronize()
        init_train_s = time.perf_counter() - t0
        trained = set(trainer.trainable)
        weights_train = torch.cuda.memory_allocated(device) / 2**30
        # the frozen tensors, held on the host to be compared after the steps
        t0 = time.perf_counter()
        frozen = {n: t.detach().cpu() for n, t in model.state_dict().items() if n not in trained}
        copy_s = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats(device)
        for c in training_counters(fa):
            c.launches = 0
        t0 = time.perf_counter()
        train_steps(model, [batch] * TRAIN_STEPS, tc, trainer=trainer)
        torch.cuda.synchronize()
        total_ms = (time.perf_counter() - t0) * 1e3
        train_counts = {c.__name__: c.launches for c in training_counters(fa)}
        peak_train = torch.cuda.max_memory_allocated(device) / 2**30
        with open(f"{out_dir}/train_log.jsonl") as f:
            log = [json.loads(line) for line in f]
    losses = [r["loss"] for r in log]
    steady_ms = (log[-1]["time"] - log[-2]["time"]) * 1e3
    per_step = {"flash_attention_lse": 2 * n_vit, "flash_attention_bwd_dq": n_vit,
                "flash_attention_bwd_dkv": n_vit, "flash_attention_qkv_lse": 2 * n_llm,
                "flash_attention_qkv_bwd_dq": n_llm, "flash_attention_qkv_bwd_dkv": n_llm}
    want = {n: per_step.get(n, 0) * TRAIN_STEPS for n in train_counts}
    if train_counts != want:
        raise RuntimeError(f"26B train: launches {train_counts} for {TRAIN_STEPS} steps, "
                           f"expected {want}")
    if len(losses) != TRAIN_STEPS or not np.isfinite(losses).all():
        raise RuntimeError(f"26B train: losses {losses}")
    state = model.state_dict()
    moved = [n for n, t in frozen.items() if not torch.equal(state[n].cpu(), t)]
    if moved:
        raise RuntimeError(f"26B train: frozen tensors changed: {moved[:5]}")
    n_frozen = sum(t.numel() for t in frozen.values())
    del frozen, state
    phase("slice", f"InternVL2-26B stage-2 LoRA training, full depth, r={LORA_RANK} both towers, "
          f"bf16 frozen ({n_frozen / 1e9:.2f} G values) with fp32 adapters and score head, "
          f"checkpointing on, dropout {lora_cfg.lora_dropout}, drop path "
          f"{lora_cfg.vision.drop_path_rate}, micro-batch {TRAIN_26B_VIDEOS} videos x {FRAMES} "
          f"frames {IMAGE}px, seq {ids.shape[-1]}, {TRAIN_STEPS} steps at constant lr "
          f"{TRAIN_LR}: launches per micro-batch "
          f"{ {k: v // TRAIN_STEPS for k, v in train_counts.items() if v} }; {steady_ms:.1f} "
          f"ms/step (the last), {total_ms / TRAIN_STEPS:.1f} ms/step over the call; peak "
          f"{peak_train:.2f} GiB allocated (weights {weights_train:.2f} GiB), init "
          f"{init_train_s:.1f} s; losses {np.round(losses, 5).tolist()}; frozen tensors "
          f"bit-equal (host copy, {copy_s:.1f} s) [{smi}]")
    out.update(train_counts=train_counts, step_ms=steady_ms, train_peak_gib=peak_train,
               n_vit=n_vit, n_llm=n_llm)
    del model, trainer
    gc.collect()
    torch.cuda.empty_cache()
    return out


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
    from aigv_assessor_torch.core.precision import COMPONENTS, Precision
    from aigv_assessor_torch.models.assessor import AIGVAssessor
    from aigv_assessor_torch.ops import cuda_build
    from aigv_assessor_torch.ops import decode_attention as dec
    from aigv_assessor_torch.ops import flash_attention as fa
    from aigv_assessor_torch.ops import int8_matmul as wo
    from aigv_assessor_torch.ops import quant_fuse as qf
    from aigv_assessor_torch.ops.attention import two_part_cached_attention
    from aigv_assessor_torch.ops.preprocess import resize_normalize

    # 2. build, always from the checkout's sources
    libs = (fa.LIB, fa.LIB_BWD, qf.LIB, wo.LIB, dec.LIB)
    for lib in libs:
        lib.path.unlink(missing_ok=True)
    build_s = cuda_build.build(libs, verbose=True)
    phase("build", f"{', '.join(lib.source.name for lib in libs)} -> "
          f"{', '.join(lib.path.name for lib in libs)} for sm_90a in {build_s:.2f} s")

    # 3. kernels against their plain versions
    shapes = check_attention(fa, device)
    train_shapes = check_attention_training(fa, device)
    feeds = check_feeds(qf, device)
    separate = check_attention_separate(fa, device)
    separate_train = check_attention_separate_training(fa, device, SEPARATE_TRAIN)
    matmuls = check_weight_only(wo, device)
    decode = check_decode_attention(dec, two_part_cached_attention, device)

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
        counters = (fa.flash_attention_qkv, qf.layernorm_quant, qf.gelu_quant, qf.quant_rows,
                    qf.rmsnorm_quant, qf.silu_mul_quant,
                    fa.flash_attention, wo.int8_matmul, wo.int4_matmul,
                    fa.flash_attention_qkv_lse, fa.flash_attention_qkv_bwd_dq,
                    fa.flash_attention_qkv_bwd_dkv, dec.decode_attention)
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

    def expected(**per_forward_launches) -> dict:
        """Launch counts of CHUNKS forwards: the named kernels, 0 of the rest."""
        names = ("flash_attention_qkv", "layernorm_quant", "gelu_quant", "quant_rows",
                 "rmsnorm_quant", "silu_mul_quant",
                 "flash_attention", "int8_matmul", "int4_matmul", "flash_attention_qkv_lse",
                 "flash_attention_qkv_bwd_dq", "flash_attention_qkv_bwd_dkv",
                 "decode_attention")
        return {n: per_forward_launches.get(n, 0) * CHUNKS for n in names}

    counts, ms_bf16, peak_bf16, weights_bf16, arr = run_slice(model, "bf16")
    want = expected(flash_attention_qkv=per_forward)
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
    want = expected(flash_attention_qkv=per_forward, layernorm_quant=FEEDS["ln_quant"][2],
                    gelu_quant=FEEDS["gelu_quant"][2], quant_rows=FEEDS["ident_quant"][2])
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
    del kernel_out, plain_out, ref_out, pv

    # 5b. the same int8 weights with every feed fused: K5a, K5b and K4c into wo
    fused_precision = dataclasses.replace(model.precision, fuse_quant=COMPONENTS,
                                          quant_rows=COMPONENTS)
    with torch.device("meta"):
        fused = AIGVAssessor(cfg, fused_precision)
    fused.load_state_dict(model.state_dict(), strict=True, assign=True)  # shares the tensors
    fused.eval()
    counts_f, ms_fused, peak_fused, _, arr_f = run_slice(fused, "W8A8 fused")
    want = expected(flash_attention_qkv=per_forward, layernorm_quant=FEEDS["ln_quant"][2],
                    gelu_quant=FEEDS["gelu_quant"][2], quant_rows=n_vit + n_llm,
                    rmsnorm_quant=FEEDS["rmsnorm_quant"][2],
                    silu_mul_quant=FEEDS["silu_mul_quant"][2])
    if counts_f != want:
        raise RuntimeError(f"W8A8 fused: launches {counts_f} for {CHUNKS} forwards, expected "
                           f"{want}")
    fused_swaps = plain_swaps + ((qf, "rmsnorm_quant", qf.plain_rmsnorm_quant),
                                 (qf, "silu_mul_quant", qf.plain_silu_mul_quant))
    with torch.device("meta"):
        ref = AIGVAssessor(cfg, dataclasses.replace(fused_precision, compute_dtype=torch.float32))
    ref.load_state_dict({k: v.float() if v.is_floating_point() else v
                         for k, v in fused.state_dict().items()}, strict=True, assign=True)
    with torch.inference_mode():
        pv = resize_normalize(px_u8, size=IMAGE, dtype=torch.float32)
        kernel_out = fused(ids[:, 0], pv.to(torch.bfloat16), mask[:, 0])
        launched = [getattr(m, n).launches for m, n, _ in fused_swaps]
        with contextlib.ExitStack() as stack:
            for module, name, plain in fused_swaps:
                stack.enter_context(mock.patch.object(module, name, plain))
            plain_out = fused(ids[:, 0], pv.to(torch.bfloat16), mask[:, 0])
            ref_out = ref.eval()(ids[:, 0], pv, mask[:, 0])
        if [getattr(m, n).launches for m, n, _ in fused_swaps] != launched:
            raise RuntimeError("the plain fused W8A8 forwards launched a kernel")
    del ref
    kf, pf, rf = (o["readout"].float() for o in (kernel_out, plain_out, ref_out))
    relf, relf_kr, relf_pr = relative_l2(kf, pf), relative_l2(kf, rf), relative_l2(pf, rf)
    if not torch.isfinite(kf).all() or not relf <= W8A8_READOUT_TOL:
        raise RuntimeError(f"W8A8 fused readout relative L2 kernel vs plain {relf} above "
                           f"{W8A8_READOUT_TOL}")
    if not relf_kr <= REF_RATIO * relf_pr:
        raise RuntimeError(f"W8A8 fused kernel path {relf_kr} from the fp32-activation "
                           f"reference, plain path {relf_pr}: more than {REF_RATIO}x farther")

    def cosine(x, y):
        x, y = x.flatten(), y.flatten()
        return (x @ y / (x.norm() * y.norm())).item()

    cos_bf16, cos_unfused = cosine(kf, readout_bf16), cosine(kf, k8)
    if not cos_bf16 >= W8A8_COSINE:
        raise RuntimeError(f"W8A8 fused readout cosine to bf16 {cos_bf16} below {W8A8_COSINE}")
    phase("slice", f"W8A8 fused decoder feeds (fuse_quant = quant_rows = vit, llm), same int8 "
          f"weights, seed and videos: launches per forward "
          f"{ {k: v // CHUNKS for k, v in counts_f.items() if v} }, {ms_fused:.1f} ms/chunk "
          f"(unfused W8A8 {ms_w8a8:.1f}, bf16 {ms_bf16:.1f}), peak {peak_fused:.2f} GiB "
          f"allocated (unfused {peak_w8a8:.2f}, bf16 {peak_bf16:.2f}); readout rel L2 kernel vs "
          f"plain {relf:.3e} (tol {W8A8_READOUT_TOL}), vs fp32-activation fused reference: "
          f"kernel {relf_kr:.3e}, plain {relf_pr:.3e} (tol {REF_RATIO}x); cosine to bf16 "
          f"{cos_bf16:.5f} (tol {W8A8_COSINE}), to the unfused W8A8 readout {cos_unfused:.5f}; "
          f"scores {np.round(arr_f[:, 0], 4).tolist()} [{smi}]")
    fused_stats = dict(ms=ms_fused, peak_gib=peak_fused, counts=counts_f,
                       cosine_bf16=cos_bf16, cosine_unfused=cos_unfused)
    del model, fused, kernel_out, plain_out, ref_out, pv
    torch.cuda.empty_cache()

    # 6. the weight-only scoring slices: same seed, same videos
    def run_weight_only_slice(bits: int) -> dict:
        label = f"int{bits}"
        matmul = f"int{bits}_matmul"
        t0 = time.perf_counter()
        model = build_serving_model(cfg, device=device, seed=0, **{label: True})
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        llm = model.language_model
        quantized = [m for m in llm.modules() if hasattr(m, "weight_scale")]
        linear = type(llm.output).__name__
        if (len(quantized) != 5 * n_llm + 1 or {type(m).__name__ for m in quantized} != {linear}
                or linear != f"Int{bits}Linear"
                or any(hasattr(m, "weight_scale") for m in model.vision_model.modules())):
            raise RuntimeError(f"{label}: the decoder's projections and LM head are not all "
                               f"Int{bits}Linear, or the ViT is not float")
        counts_q, ms_q, peak_q, weights_q, arr_q = run_slice(model, label)
        want = expected(**{"flash_attention_qkv": n_vit, "flash_attention": n_llm,
                           matmul: 5 * n_llm})
        if counts_q != want:
            raise RuntimeError(f"{label}: launches {counts_q} for {CHUNKS} forwards, "
                               f"expected {want}")
        swaps = ((fa, "flash_attention_qkv", fa.plain_attention_qkv),
                 (fa, "flash_attention", fa.plain_flash_attention),
                 (wo, "int8_matmul", wo.plain_int8_matmul),
                 (wo, "int4_matmul", wo.plain_int4_matmul))
        # the bf16 model whose decoder weights are the dequantized values
        state = {}
        for name, t in model.state_dict().items():
            if name.endswith(".weight_scale"):
                continue
            if t.dtype == torch.int8:
                module = model.get_submodule(name[: -len(".weight")])
                deq = (wo.dequantize_kernel(t, module.weight_scale) if bits == 8 else
                       wo.dequantize_kernel_int4(t, module.weight_scale, module.in_features))
                t = deq.to(torch.bfloat16)
            state[name] = t
        with torch.device("meta"):
            ref = AIGVAssessor(cfg, Precision())
        ref.load_state_dict(state, strict=True, assign=True)
        del state
        with torch.inference_mode():
            pv = resize_normalize(px_u8, size=IMAGE, dtype=torch.bfloat16)
            kernel_out = model(ids[:, 0], pv, mask[:, 0])
            deq_out = ref.eval()(ids[:, 0], pv, mask[:, 0])
            launched = [getattr(m, n).launches for m, n, _ in swaps]
            with contextlib.ExitStack() as stack:
                for module, name, plain in swaps:
                    stack.enter_context(mock.patch.object(module, name, plain))
                plain_out = model(ids[:, 0], pv, mask[:, 0])
            if [getattr(m, n).launches for m, n, _ in swaps] != launched:
                raise RuntimeError(f"the plain {label} forward launched a kernel")
        del ref
        kq, pq, dq = (o["readout"].float() for o in (kernel_out, plain_out, deq_out))
        rel_plain, rel_deq = relative_l2(kq, pq), relative_l2(kq, dq)
        if not torch.isfinite(kq).all() or not rel_plain <= WEIGHT_ONLY_READOUT_TOL:
            raise RuntimeError(f"{label} readout relative L2 kernel vs plain {rel_plain} above "
                               f"{WEIGHT_ONLY_READOUT_TOL}")
        if not rel_deq <= WEIGHT_ONLY_READOUT_TOL:
            raise RuntimeError(f"{label} readout relative L2 kernel path vs the bf16 model of "
                               f"the dequantized weights {rel_deq} above "
                               f"{WEIGHT_ONLY_READOUT_TOL}")
        a, bf = kq.flatten(), readout_bf16.flatten()
        cosine = (a @ bf / (a.norm() * bf.norm())).item()
        if bits == 8 and not cosine >= INT8_COSINE:
            raise RuntimeError(f"int8 readout cosine to bf16 {cosine} below {INT8_COSINE}")
        per_fwd = {k: v // CHUNKS for k, v in counts_q.items() if v}
        phase("slice", f"{label} weight-only InternVL2-2B stage-2 scoring, same seed and "
              f"videos: launches per forward {per_fwd}, {ms_q:.1f} ms/chunk (bf16 "
              f"{ms_bf16:.1f}), peak {peak_q:.2f} GiB allocated (bf16 {peak_bf16:.2f}), weights "
              f"{weights_q:.2f} GiB (bf16 {weights_bf16:.2f}), init {init_s:.1f} s; readout rel "
              f"L2 kernel vs plain versions {rel_plain:.3e}, vs the bf16 model of the "
              f"dequantized weights {rel_deq:.3e} (tol {WEIGHT_ONLY_READOUT_TOL}), cosine to "
              f"bf16 {cosine:.5f}{f' (tol {INT8_COSINE})' if bits == 8 else ''}; scores "
              f"{np.round(arr_q[:, 0], 4).tolist()} [{smi}]")
        return counts_q

    counts_int8 = run_weight_only_slice(8)
    torch.cuda.empty_cache()
    counts_int4 = run_weight_only_slice(4)
    torch.cuda.empty_cache()

    # 7. the stage-2 training slice
    train_counts = run_train_slice(cfg, device, ids, mask, px_u8, rng, per_forward, smi)
    torch.cuda.empty_cache()

    # 7b. stage-1 training at 2B
    run_stage1_slice(device, px_u8, n_vit, n_llm, smi)
    torch.cuda.empty_cache()

    # 8. generation: bf16, int8 weights, bf16 with the int8 KV cache
    gen_kw = dict(n_llm=n_llm, n_vit=n_vit)
    gen_bf16 = run_generation(cfg, device, ids[:, 0], px_u8, smi, label="bf16", **gen_kw)
    gen_int8 = run_generation(cfg, device, ids[:, 0], px_u8, smi, label="int8", int8=True,
                              bf16_logits=gen_bf16["logits"], **gen_kw)
    run_generation(cfg, device, ids[:, 0], px_u8, smi, label="bf16 + kv_int8", kv_int8=True,
                   bf16_logits=gen_bf16["logits"], **gen_kw)

    # 9. shared-prefix perspective scoring
    run_shared_prefix(cfg, device, videos, rng, smi, n_vit=n_vit, n_llm=n_llm)
    torch.cuda.empty_cache()

    # 10. the score CLI on video files
    run_score_cli(device, smi, n_llm=n_llm)

    # 11. InternVL2-26B: every earlier model is gone; the 26B model takes
    # 47.5 GiB in bf16
    import gc
    gc.collect()
    torch.cuda.empty_cache()
    big = run_26b(device, ids, mask, px_u8, videos, ids_pn, mask_pn, smi)

    # One entry per kernel form. ms, plain_ms, bound_ms and library_ms are
    # the sums over the launches of one unit of the main path (one scoring
    # forward, or one training micro-batch) at the path's shapes; the
    # per-launch numbers at each shape are under `shapes`.
    fwd_src = dict(route="cuda", source="aigv_assessor_torch/csrc/flash_attn_fwd.cu",
                   replaces="aigv_assessor_tpu/ops/pallas_attention.py:106")
    bwd_src = dict(route="cuda", source="aigv_assessor_torch/csrc/flash_attn_bwd.cu")

    def per_unit(table, key, times=1):
        return times * (n_vit * table["vit"][key] + n_llm * table["llm"][key])

    def per_unit_bound(kind, times=1):
        return times * (n_vit * train_shapes["vit"]["bounds"][kind]["bound_ms"]
                        + n_llm * train_shapes["llm"]["bounds"][kind]["bound_ms"])

    sdpa_note = ("F.scaled_dot_product_attention on the same q/k/v views, enable_gqa for "
                 "GQA, k and v cut at kv_valid")
    kernels = [
        dict(name="flash_attn_qkv_fwd", **fwd_src, launches=launches_bhsd,
             max_abs_err=max(r["max_abs_err"] for r in shapes.values()),
             ms=per_unit(shapes, "ms"), plain_ms=per_unit(shapes, "plain_ms"),
             bound_ms=per_unit(shapes, "bound_ms"), bound_by=shapes["vit"]["bound_by"],
             library_ms=per_unit(shapes, "library_ms"), library=sdpa_note,
             unit="one scoring forward: 24 launches at the vit shape, 24 at the llm shape",
             shapes=shapes),
        dict(name="flash_attn_qkv_fwd_bsd", **fwd_src,
             launches=counts8["flash_attention_qkv"],
             max_abs_err=max(r["bsd_max_abs_err"] for r in shapes.values()),
             ms=per_unit(shapes, "bsd_ms"), plain_ms=per_unit(shapes, "bsd_plain_ms"),
             bound_ms=per_unit(shapes, "bound_ms"), bound_by=shapes["vit"]["bound_by"],
             library_ms=per_unit(shapes, "library_ms"),
             library=sdpa_note + "; its output is head-major, the dense rows would cost a copy",
             unit="one W8A8 scoring forward: 24 + 24 launches"),
        dict(name="flash_attn_qkv_fwd_lse", **fwd_src,
             launches=train_counts["flash_attention_qkv_lse"],
             max_abs_err=max(r["lse_max_abs_err"] for r in train_shapes.values()),
             ms=per_unit(train_shapes, "lse_ms", 2),
             plain_ms=per_unit(train_shapes, "plain_lse_ms", 2),
             bound_ms=per_unit_bound("fwd_lse", 2),
             bound_by=train_shapes["vit"]["bounds"]["fwd_lse"]["bound_by"],
             library_ms=per_unit(shapes, "library_ms", 2),
             library=sdpa_note + " (forward; it keeps its own logsumexp)",
             unit="one training micro-batch: first pass and recompute, 2 x (24 + 24) launches",
             shapes=train_shapes),
        dict(name="flash_attn_qkv_bwd_dq", **bwd_src,
             replaces="aigv_assessor_tpu/ops/pallas_attention.py:384",
             launches=train_counts["flash_attention_qkv_bwd_dq"],
             max_abs_err=max(r["max_abs_err"]["dq"] for r in train_shapes.values()),
             ms=per_unit(train_shapes, "dq_ms"), plain_ms=per_unit(train_shapes, "plain_bwd_ms"),
             bound_ms=per_unit_bound("dq"),
             bound_by=train_shapes["vit"]["bounds"]["dq"]["bound_by"],
             library_ms=per_unit(train_shapes, "library_bwd_ms"),
             library=sdpa_note + ": its backward gives dq, dk and dv in one call, so the same "
             "time stands beside both backward kernels; plain_ms is the whole plain backward",
             unit="one training micro-batch: 24 + 24 launches"),
        dict(name="flash_attn_qkv_bwd_dkv", **bwd_src,
             replaces="aigv_assessor_tpu/ops/pallas_attention.py:455",
             launches=train_counts["flash_attention_qkv_bwd_dkv"],
             max_abs_err=max(max(r["max_abs_err"]["dk"], r["max_abs_err"]["dv"])
                             for r in train_shapes.values()),
             ms=per_unit(train_shapes, "dkv_ms"), plain_ms=per_unit(train_shapes, "plain_bwd_ms"),
             bound_ms=per_unit_bound("dkv"),
             bound_by=train_shapes["vit"]["bounds"]["dkv"]["bound_by"],
             library_ms=per_unit(train_shapes, "library_bwd_ms"),
             library="as for flash_attn_qkv_bwd_dq",
             unit="one training micro-batch: 24 + 24 launches"),
    ]
    llm_sep = separate["llm"]
    kernels.append(dict(
        name="flash_attn_fwd", route="cuda",
        source="aigv_assessor_torch/csrc/flash_attn_fwd.cu",
        replaces="aigv_assessor_tpu/ops/pallas_attention.py:352",
        launches=counts_int8["flash_attention"],
        max_abs_err=max(r["max_abs_err"] for r in separate.values()),
        ms=n_llm * llm_sep["ms"], plain_ms=n_llm * llm_sep["plain_ms"],
        bound_ms=n_llm * llm_sep["bound_ms"], bound_by=llm_sep["bound_by"],
        library_ms=n_llm * llm_sep["library_ms"],
        library="F.scaled_dot_product_attention on head-major views of the same q, k, v",
        unit="one weight-only scoring forward: 24 launches at the llm shape, bshd views of one "
        "row-major projection", shapes=separate))
    for bits, replaces, counts_q in ((8, 31, counts_int8), (4, 113, counts_int4)):
        table = matmuls[bits]

        def per_forward_sum(key):
            return n_llm * sum(per_layer * table[name][key]
                               for name, (_, _, per_layer) in PROJECTIONS.items())
        kernels.append(dict(
            name=f"weight_only_int{bits}_matmul", route="cuda",
            source="aigv_assessor_torch/csrc/weight_only_matmul.cu",
            replaces=f"aigv_assessor_tpu/ops/int8_matmul.py:{replaces}",
            launches=counts_q[f"int{bits}_matmul"],
            max_abs_err=max(r["max_abs_err"] for r in table.values()),
            ms=per_forward_sum("ms"), plain_ms=per_forward_sum("plain_ms"),
            bound_ms=per_forward_sum("bound_ms"), bound_by=table["w2"]["bound_by"],
            library_ms=per_forward_sum("library_ms"),
            library="F.linear in bf16 on a weight dequantized beforehand: the same product "
            f"with {16 // bits} times the weight bytes",
            unit=f"one int{bits} scoring forward: 24 layers x (wqkv, wo, w1, w3, w2) at M = "
            f"{PREFILL_ROWS}", shapes=table))
    for name, counter in (("ln_quant", "layernorm_quant"), ("gelu_quant", "gelu_quant"),
                          ("ident_quant", "quant_rows"), ("rmsnorm_quant", "rmsnorm_quant"),
                          ("silu_mul_quant", "silu_mul_quant")):
        rows, cols, per_fwd, replaces = FEEDS[name]
        f = feeds[name]
        decoder = name in ("rmsnorm_quant", "silu_mul_quant")
        unit = (f"one W8A8 scoring forward with fused decoder feeds: {per_fwd} launches"
                if decoder else f"one W8A8 scoring forward: {per_fwd} launches")
        extra = {}
        if name == "ident_quant":  # and 24 more into the decoder's wo when fused
            extra = dict(launches_fused_feeds=fused_stats["counts"]["quant_rows"],
                         unit_fused_feeds=f"{n_vit} at {rows}x{cols} (ViT proj) + {n_llm} at "
                         f"{PREFILL_ROWS}x{cfg.llm.hidden_size} (decoder wo) per forward")
        kernels.append(dict(
            name=name, route="cuda", source="aigv_assessor_torch/csrc/quant_fuse.cu",
            replaces=replaces,
            launches=fused_stats["counts"][counter] if decoder else counts8[counter],
            max_abs_err=f["max_abs_err"], ms=per_fwd * f["ms"], plain_ms=per_fwd * f["plain_ms"],
            bound_ms=per_fwd * f["bound_ms"], bound_by=f["bound_by"], library_ms=None,
            library="none: no single PyTorch call computes the fused function",
            unit=unit, detail=f, **extra))
    path = decode["path"]
    kernels.append(dict(
        name="decode_attention", route="cuda",
        source="aigv_assessor_torch/csrc/decode_attention.cu",
        replaces="aigv_assessor_tpu/ops/decode_attention.py:64",
        launches=gen_bf16["counts"]["decode_attention"],
        max_abs_err=max(r["max_abs_err"] for r in decode.values()),
        ms=n_llm * path["ms"], plain_ms=n_llm * path["plain_ms"],
        bound_ms=n_llm * path["bound_ms"], bound_by=path["bound_by"],
        library_ms=n_llm * path["library_ms"], eager_ms=n_llm * path["eager_ms"],
        library="F.scaled_dot_product_attention with a one-token query on head-major views "
        "of the cache rows below end, enable_gqa",
        eager_two_part_ms=n_llm * path["two_part_ms"],
        unit=f"one decode step of the bf16 generate: {n_llm} launches at B = {BATCH}, end = "
        f"{DECODE_SHAPES['path'][5]}, cache layers read from device memory; ms, plain_ms, "
        "library_ms and eager_two_part_ms are device times by CUDA graph replay, eager_ms is "
        "the wrapper called launch by launch with the host's cost; launches are those "
        f"of one {GEN_TOKENS}-token generate ({gen_int8['counts']['decode_attention']} with int8 "
        "weights, 0 under kv_int8)", shapes=decode))
    # K2's training forms: one 26B training micro-batch, n_vit launches of each
    # at the vit_6b_train shape (the logsumexp form twice: pass and recompute)
    n_vit26 = big["n_vit"]
    unit26 = SEPARATE_TRAIN["vit_6b_train"]
    k2_unit = (f"one InternVL2-26B training micro-batch of {TRAIN_26B_VIDEOS} videos: "
               f"{{}} launches at the vit_6b_train shape ({unit26[0]} frames)")
    k2 = separate_train["vit_6b_train"]

    def k2_entry(name, key, kind, counter, replaces, times, library_ms, library):
        return dict(
            name=name, route="cuda", source=f"aigv_assessor_torch/csrc/{key}",
            replaces=f"aigv_assessor_tpu/ops/pallas_attention.py:{replaces}",
            launches=big["train_counts"][counter],
            max_abs_err=max((r["lse_max_abs_err"] if kind == "fwd_lse" else
                             max(r["max_abs_err"][g] for g in kind_grads[kind]))
                            for r in separate_train.values()),
            ms=times * n_vit26 * k2[f"{kind_ms[kind]}_ms"],
            plain_ms=times * n_vit26 * k2["plain_lse_ms" if kind == "fwd_lse" else "plain_bwd_ms"],
            bound_ms=times * n_vit26 * k2["bounds"][kind]["bound_ms"],
            bound_by=k2["bounds"][kind]["bound_by"], library_ms=times * n_vit26 * library_ms,
            library=library, unit=k2_unit.format(times * n_vit26), shapes=separate_train)

    kind_grads = {"dq": ("dq",), "dkv": ("dk", "dv")}
    kind_ms = {"fwd_lse": "lse", "dq": "dq", "dkv": "dkv"}
    k2_lib = ("F.scaled_dot_product_attention on head-major views of the same q, k, v, k and "
              "v cut at kv_valid")
    kernels += [
        k2_entry("flash_attn_fwd_lse", "flash_attn_fwd.cu", "fwd_lse", "flash_attention_lse",
                 352, 2, k2["library_ms"], k2_lib + " (forward; it keeps its own logsumexp)"),
        k2_entry("flash_attn_bwd_dq", "flash_attn_bwd.cu", "dq", "flash_attention_bwd_dq", 602,
                 1, k2["library_fwd_bwd_ms"], k2_lib + ": forward and backward in one timed "
                 "call, the same time beside both backward kernels; plain_ms is the whole "
                 "plain backward"),
        k2_entry("flash_attn_bwd_dkv", "flash_attn_bwd.cu", "dkv", "flash_attention_bwd_dkv",
                 618, 1, k2["library_fwd_bwd_ms"], "as for flash_attn_bwd_dq"),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
