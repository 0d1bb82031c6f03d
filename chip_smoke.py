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
   (`csrc/weight_only_matmul.cu`), the decode attention
   (`csrc/decode_attention.cu`) and the fp8 decode matmul
   (`csrc/fp8_matmul.cu`).
3. kernel: each kernel against its plain PyTorch version on the same inputs,
   both timed with CUDA events after warm-up, beside its bound (the larger of
   bytes / 3.35 TB/s and operations / 989 TFLOP/s, from this run's shapes)
   and, for attention, `F.scaled_dot_product_attention` on the same q/k/v
   views (GQA through `enable_gqa=True`, `kv_valid` by slicing k and v) as
   the library yardstick, which nothing in the port calls.
   - The flash-attention kernel in both output layouts, at the ViT's and the
     LLM's shapes of the 2B model, at a small ragged shape with a +-1e3
     garbage tail and at the borders of its tiles (one row, 127 / 129 / 257
     rows, kv_valid 1 and inside a tile, causal at ragged S, G = 6, 25 heads
     of 128), to atol = rtol = 2e-2. Its dense `bsd` output must equal its
     head-major `bhsd` output transposed, bit for bit. Every forward form
     and SDPA are timed by CUDA graph replay in turn (device time; `bhsd`
     also call by call), with achieved TFLOP/s and the share of the bound.
   - The forward with logsumexp and the backward (one kernel a key tile) at
     the same shapes and at the 20B decoder's (B = 2, 48 / 8 heads, S =
     2113, causal) and the backward's tile borders (63 / 65 / 191 / 193
     rows, kv_valid one past a 64-key tile): `out` bit-equal to the forward
     without logsumexp; the logsumexp within LSE_TOL of the plain fp32 one;
     dq, dk and dv each within BWD_TOL relative L2 of
     `plain_attention_qkv_bwd` on the same (qkv, out, lse, dout), which
     rounds p and ds to bf16 where the kernels do (where each row has one
     valid key, and dq and dk are 0 in exact arithmetic, dq and dk within
     ZERO_GRAD_ATOL of 0 instead); dk/dv rows of the keys at or beyond
     kv_valid exactly 0; delta as the backward's first launch writes it
     within DELTA_TOL relative L2 of the fp32 expression; a second run
     bit-equal to the first (dQ summed over the key tiles in a fixed order).
     The backward (one kernel a key tile between delta and dq's convert)
     timed by CUDA graph replay beside the eager delta it replaces, the plain
     backward and SDPA's backward alone.
   - The LayerNorm / tanh-GELU / identity + int8 quantize kernels (device
     time by CUDA graph replay, and call by call with the host) at the 2B
     ViT's feed shapes, and the RMSNorm / SwiGLU + int8 kernels at the 2B
     decoder's (K5b also at the 8B decoder's 14336-wide feed), each also at a
     ragged row count: scales within rtol 1e-5, int8 values differing by at
     most one on at most 1e-3 of the elements; on `tools/quant_fuse_ab.tie_grid`'s
     rows, where every y / s is a half-integer or an integer, q and s equal
     the exact rint(y / s) of every producer bit for bit.
   - The forward on three separate tensors at the LLM's shape (`bshd` views
     of one row-major projection output, causal, GQA), at the ViT's shape in
     both layouts with kv_valid 1025 of 1032, at a non-causal Sq != Skv shape
     and at the ragged shape, to the same atol = rtol = 2e-2; and against the
     fused-qkv kernel on the same data, with which it shares its body:
     bit-equal. Yardstick: SDPA on the same views.
   - K2's training forms on three tensors (the forward with logsumexp and
     the backward) at InternViT-6B's shape (B = 32 frames of a
     scoring chunk, and the frames of one 26B training micro-batch; 25
     heads, S = 1032 with kv_valid 1025, D = 128, `bshd`, q and k from the
     norms, v a strided view of the projection), at the 2B decoder's
     row-major shape (B = 4, 16 / 8 heads, S = 2113, causal, `bshd` views),
     at a ragged non-causal Sq != Skv shape (`bhsd`, GQA, garbage tail) and
     at the forward's tile borders (Sq > Skv, Sq < Skv at G = 6, kv_valid =
     1 at 25 heads, one query row) and the backward's (193 rows with
     kv_valid 65, causal at 65 rows):
     `out` bit-equal to the forward without logsumexp, the logsumexp within
     LSE_TOL, dq, dk and dv within BWD_TOL relative L2 of
     `plain_flash_attention_bwd`, dk / dv of masked keys exactly 0, delta
     within DELTA_TOL, a second run bit-equal. Timed by CUDA graph replay
     beside the bound, the plain versions, SDPA's forward, SDPA's backward
     alone and SDPA's forward + backward.
   - The weight-only int8 and int4 matmuls, each in the form its wrapper
     picks (`ops/int8_matmul.weight_only_form`): at the decoder's projection
     shapes with M = 8452 rows (4 videos x 2113 tokens; the GEMM form, and
     the unaligned form on the same inputs), at the decode sizes M = 4 and
     M = 1 of the same shapes (the GEMV form, cycling over enough copies of
     the weight that none is found in the L2 cache), at the LM head
     (2048 -> 92553) with M = 4, at the forms' and tiles' borders (WO_BORDERS:
     M = 8 / 9 / 16 / 17 / 64 / 65 / 127 / 128 / 129 / 255 / 256 / 257, N =
     127 / 128 / 129 / 255 / 256 / 257, K = 64 / 160 / 100; each through the
     wrapper, which must take the expected form,
     and through every form that takes it), the GEMM form where its schedule
     changes (WO_GEMM_EDGES: 131 to 529 tiles on 132 SMs, the 2B wo / w2's
     544 with a last m tile of 4 rows; a second launch and a CUDA graph
     replay bit-equal to the first), at the 26B / 4B / 1B decoders'
     projections with M = 8452 (WO_OTHER, timed beside `F.linear`), and for
     int4 at an odd K (the unaligned form): relative L2 at most WO_TOL from
     the plain version,
     which multiplies the same bf16 inputs in fp32; against that version
     rounded to bf16, all but WO_UNEQUAL_SHARE of the elements equal and all
     but WO_ULP_SHARE within one bf16 ulp; and exactly 0 for an all-zero
     weight column. Timed by CUDA graph replay. Yardstick, which nothing in
     the port calls: `F.linear` in bf16 on a weight dequantized beforehand,
     the same product with two or four times the weight bytes.
   - The decode-attention kernel at the decode step's shape (B = 4, 16 / 8
     heads, D = 128, a cache of 2177 rows; `end` = 2113 with full windows and
     2150 with ragged `starts`), with `end` = 0, with windows of one row and
     at D = 64: `out` within DECODE_TOL of `plain_decode_attention`, `m` and
     `l` within DECODE_ML_RTOL; rows outside the windows hold NaN for the
     kernel, which must not load them; the fused entry (the window and the
     current token in one launch, `cached_decode_attention`) within
     DECODE_TOL of `plain_cached_decode_attention` at every shape, with NaN
     outside the windows, and of `two_part_cached_attention`; at the path
     shape its launch captured in a CUDA graph and replayed three times,
     bit-equal to the eager call. Timed over a stack of layers larger than
     the L2 cache, as a CUDA graph's replay (device time) and call by call
     (with the host's launch cost): the fused entry, the window alone (the
     same kernel without the merge), the window plus the eager
     `merge_new_token`, beside their byte bounds, the plain versions, the
     eager `two_part_cached_attention` with one token and SDPA with a
     one-token query; and with every window DECODE_SHORT rows long, which
     must not take longer than full windows.
   - The activation and cache quantizers (`ops/w8a8.quantize_rows`,
     `ops/kv_quant.quantize_kv_rows`, plain PyTorch on both devices) on the
     card against the CPU on the same bf16 inputs, the 2B decoder's rows and
     a cache slice: int8 values and fp32 scales bit-equal.
   - The fp8 (e4m3) decode matmul (K9) at the fp8 probe's three decode
     matvecs of InternLM2-1.8B (wqkv 2048 -> 4096, w1 / w3 fused 2048 ->
     16384, w2 8192 -> 2048) at M = 1, 4, 8 and at a ragged M = 3, K = 2050,
     N = 4100, at every split border (`fp8_split_borders`: splits of 8 and 16
     warps on this card, K = 8256, K below one step, N below one tile), and
     on a weight that holds every finite e4m3 code: the quantized weight holds
     no NaN byte, the kernel is within FP8_TOL relative L2 of the plain version
     rounded to bf16, an all-zero channel gives exactly 0, a second launch and
     a CUDA graph replay are bit-equal to the first launch, the launch's plan
     is `ops/fp8_matmul.matvec_plan`'s, and with x the identity's rows and
     scale 1 the output is the weight's columns as `w8.to(bfloat16)` gives
     them, bit for bit, over every finite code. Timed by CUDA
     graph replay over weight copies that exceed the L2 cache, beside its
     byte bound, the plain version and `F.linear` on the bf16 weight, and at
     FP8_FIXED (no weight to stream: the fixed cost of a launch).
3b. fp8 probe: `tools/fp8_decode_probe.run`, K9's path, with every count set
   to 0 just before it: the four candidates (F.linear on bf16, the upcast
   fp8 weight, K9, K7's int4) on the same three shapes; K9 and K7 must
   launch, K9's error against the float product at most FP8_PROBE_ERR.
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
   three-tensor launches and 120 of the one matmul kernel, all in its GEMM
   form, none of the other, of the quantize feeds or of the training
   kernels; the readout of the kernel path against (a) the same model with
   every kernel swapped for its plain version and (b) the bf16 model whose
   decoder weights are the dequantized int8 / int4 values, both within
   WEIGHT_ONLY_READOUT_TOL; and prints the readout's cosine to the bf16
   readout (int8: at least INT8_COSINE).

7. slice (train): stage-2 LoRA training of the same model
   (`cli/stage2_train.build_training_model`, rank 8 in both towers, bf16 with
   fp32 adapters and score head, per-layer checkpointing, adapter dropout
   0.05, drop path 0.1) through `train_steps`: TRAIN_STEPS optimizer steps on
   one batch of four videos with MOS from the seed, constant learning rate
   TRAIN_LR. Checks finite losses; per micro-batch 96 launches of the
   forward with logsumexp (the first pass and the recompute of 48 layers), 48
   of the backward (each call its three launches), none of the forward without
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
   (the LLM's pass and recompute), 24 of the backward; every tower and
   SlowFast tensor bit-equal and `mlp1` / `motion_mlp` moved; the losses
   finite and the dropout-off loss lower after the steps.

7c. the training CLIs: `cli/stage2_train.main` at `--model_scale 2b` (full
   width and depth, bf16, the CLI's seed, the score head's last layer made
   non-negative) on phase 10b's meta file and videos, LoRA r = 8 in both
   towers, batch 2, 1 epoch (4 steps), an eval (batch 4) and a checkpoint
   every 2 steps; then `cli/stage1_train.main`, batch 4 (2 steps), one eval.
   Checks one finite loss per step in `train_log.jsonl`; the eval CSV
   (`pred_score` at stage 2) and the metrics lines of each eval; the best
   and last checkpoints and the artifact (`lora_weights.safetensors`,
   `trainable_weights.safetensors`); per micro-batch phase 7's and 7b's
   launches of K1 lse, K3a and K3b, and the forward-only K1 of the evals
   (48 per forward) and of stage 1's frozen ViT. Prints ms per step (two
   steps with no eval between them) beside phase 7's, and peak memory.

8. generation: `models/generation.generate` on the same model, B = 4, the
   2113-token prompt with the motion embedding, GEN_TOKENS new tokens,
   greedy, in bf16, with int8 weights, and in bf16 with the int8 KV cache.
   Checks [4, GEN_TOKENS] token ids; fused decode-attention launches = 24 x
   decode steps (0 under `kv_int8`), no window-only launch and no call of
   `merge_new_token`, 121 int8 matmuls per prefill (the GEMM form)
   and per step (the GEMV form), 24
   fused-qkv launches (the ViT); then, under a fixed token sequence
   (teacher forcing), the decode logits of the kernel path against the same
   steps on `plain_cached_decode_attention` and against the cache-free forward
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
10b. eval: the same videos under a meta file with two perspectives:
    `cli/stage1_eval.main` and `cli/stage2_eval.main`, solo and with
    `--fused_meta_paths`, at `--model_scale 2b`, batch 4, the CLIs' seed and
    the test tokenizer; the stage-2 runs in bf16, the fused one also under
    `--eval_w8a8`, and both again in fp32 through the plain attention.
    Checks the CSV headers and rows and the metrics lines; 48 fused-qkv
    attention launches per forward and no other attention kernel (W8A8: and
    the ViT's K4a-c feeds); the fused path (on the shared prefix) against
    the solo stage-2 eval (every prompt in full): in fp32 within
    EVAL_FP32_TOL, in bf16 the readouts within READOUT_TOL and no more than
    REF_RATIO as far from the fp32 readouts as the solo path's, the scores
    within EVAL_SCORE_TOL; W8A8's scores within W8A8_EVAL_DRIFT of bf16;
    prints the fused eval's videos/s lines and each call's peak memory.

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
    logsumexp (pass and recompute), 45 of K2's backward, 96 K1 lse, 48 of
    K3's; the frozen tensors bit-equal to a host copy taken
    before the steps; ms per step, peak memory.

12. serve: `cli/serve.ScoringService` behind `cli/serve._Server` on
    127.0.0.1 (port 0) at 2B, seed 0, the two CLI questions on their shared
    prefix, batch 4, 8 frames, the score head's last layer made
    non-negative; bf16, then `w8a8=True` (JAX's default feeds). The 9 CLI
    videos (phase 10's 8 mp4 + 1 GIF) are POSTed as raw bytes one at a
    time, then 32 requests come from 8 client threads. Checks every reply
    against `model.score_perspectives` on the same uint8 frames (the
    service's own decode, in batches of four videos) and every grouped
    reply against the solo one, within SCORE_TOL of the largest score
    (the batch shape is fixed: 0 expected); per batch 48 K1 launches (the
    ViT and the shared prefix; W8A8: the dense `bsd` form and the ViT's
    K4a-c) and no K8; W8A8's scores within W8A8_EVAL_DRIFT of bf16;
    `/healthz`. Prints online videos/s, p50 / p99 latency, `/statz` and,
    for bf16, `cli.score`'s videos/s on the same files.

13. Adapters over quantized bases, InternVL2-26B quantized, the ViT's
    remat policy and grids (each phase where its inputs are made):
    (a) after 10b: a LoRA checkpoint (`lora_reference`: the 2B model, seed
    0, rank LORA_RANK in both towers, lora_b drawn from N(0, LORA_B_STD))
    served with its adapters live over a W8A8, int8 and int4 base
    (`build_serving_model`), one chunk through
    `score_chunks` each: launches per forward (W8A8: 48 K1 `bsd` and no
    quantize feed; int8 / int4: 120 K6 / K7 in the GEMM form, 24 K1, 24 K2),
    the readout of the kernel path against the plain versions
    (W8A8_READOUT_TOL, WEIGHT_ONLY_READOUT_TOL) and no more than REF_RATIO as
    far from the fp32 forward with the adapters live as the plain path; the
    control (`merged_checkpoint`: the adapters folded into the fp32 bases by
    `merge_lora_`, then quantized), its distance to that forward printed
    beside; ms per chunk against the mode without adapters, peak memory.
    (b) `cli.stage2_eval.main --eval_w8a8 True` with that checkpoint (through
    `cli/common.model_weights`) on phase 10b's meta files: solo (no W8A8,
    as in JAX) and fused (W8A8 over live adapters, every feed off), fused
    again on the control; the launches of each; the fused runs' batches
    recorded and replayed on the live model built outside the CLI: the CLI's
    scores within LIVE_EVAL_TOL of the replay's, the control's further, the
    replay with the plain attention within W8A8_EVAL_DRIFT; the fused scores
    within W8A8_EVAL_DRIFT of the solo ones; wall times beside phase 10b's.
    (c) `generate` in bf16 with the adapters live, LORA_GEN_TOKENS greedy
    tokens for 4 videos: 24 K8 launches a step; the ids against the
    control's, and where they part.
    (d) after 11: InternVL2-26B built tensor by tensor in W8A8 and int4 at
    full depth and in int8 at DEPTH_CUT: every build's peak memory above the
    weights it leaves within BUILD_OVER_LARGEST x the largest fp32 tensor
    (no fp32 copy of the model, at any depth), weights, init s, ms per
    chunk, peak; launches
    per forward (K2 45 in the QK-normalized tower; W8A8: K1 `bsd` 48 in the
    decoder, K4b; int8 / int4: K2 48 and K6 / K7 240 in the decoder); at
    DEPTH_CUT the readout against the plain versions and against phase 11's
    bf16 readout.
    (e) after 7: phase 7's training with the ViT under REMAT_POLICY: the
    adapters' gradients of one training-mode step against whole-layer
    recompute (TRAIN_GRAD_TOL; bit-equality printed), K1 lse still 96 per
    micro-batch (the attention recomputed), TRAIN_STEPS steps' ms and peak
    against phase 7's.
    (f) the 2B ViT at VIT_SIZE px (a 24 x 24 grid, the position embedding
    resized, 577 tokens padded to 584) and at select_layer -2: launches and
    the output against the plain attention (READOUT_TOL).

14. Checkpoints and frames from disk, at 2B, bf16, every artifact under one
    temporary directory (free space printed first), each deleted after its
    check; the phase's wall time printed against PHASE14_BUDGET_S.
    (a) phase 10's 640x360 mp4 frames decoded at their own size,
    and a RESIZE_HD batch, through `resize_normalize(size=448)` on the card
    against the same call on the CPU (fp32 within RESIZE_FP32_TOL; bf16
    equal or one ulp in at most RESIZE_BF16_ULP_SHARE of the elements); one
    chunk scored from the mp4 frames (48 K1 launches); ms a chunk.
    (b) the model drawn from seed 0 in fp32, its JAX tree written as
    `params.safetensors` with config.json and tokenizer.json:
    `cli.score.main --model_name_or_path` on phase 10's videos bit-equal to
    the same call drawing from the seed (score head opened in both);
    start-up from the file (read; build with the weights on the card); a
    reference-format sharded bf16 checkpoint at PHASE14_CUT layers per tower
    through `reference_state_dict` and `write_sharded_safetensors`:
    `load_reference_checkpoint` and build.
    (c) `tools.convert_to_int8` at 8 and 4 bits on (b)'s file, served under
    `--int8` / `--int4`: readouts bit-equal to the in-memory build from the
    fp32 file, 120 K6 / K7 launches; the int8 file under `--w8a8`: bit-equal
    to JAX's dequantize-then-quantize computed on the host, K1 `bsd` 48 and
    K4a-c as phase 5.
    (d) at PHASE14_CUT layers per tower: phase 13a's LoRA checkpoint
    (`lora_reference`) as a JAX tree through `tools.merge_lora` (on the
    card), served without adapters: readout bit-equal to 13a's in-memory
    merged control (`merged_checkpoint`).
    (e) at PHASE14_CUT layers per tower: `tools.extract_vit`, `extract_mlp`
    and `replace_llm` on an fp32 tree's file, grafted by `--vision_path` /
    `--llm_path` / `--mlp_path` over the seed-1 model: readout bit-equal to
    seed 1's weights with the tree's three subtrees (the score head and
    SlowFast stay seed 1's).

15. The other decoders: InternVL2-4B (InternViT-300M-448px + Phi-3-mini-
    128k-instruct, `PHI3_MINI_128K`: hidden 3072, 32 layers, 32 / 32 heads of
    96) and InternVL2-1B (the same ViT + Qwen2-0.5B-Instruct, `QWEN2_05B`:
    hidden 896, 24 layers, 14 / 2 heads of 64, tied embeddings), through
    `AssessorConfig.from_dict`, weights from seed 0. Phi-3's su factor
    tables are not in the repository: a stated stand-in (short a ramp from
    1.0 to 1.1, long from 1.0 to 3.0, 48 entries each); every width is the
    published one. The prompts are phase 4's shape with ids below Phi-3's
    vocabulary.
    (a) The kernels alone at the new head shapes (`P15_SHAPES`,
    `P15_ROWS`, `P15_DECODE`): K1 at D = 96 (the forward's own D = 96
    instantiation) causal at [4, 32 / 32, 2113] and at B = 2 with its
    logsumexp and the backward (its own D = 96 instantiation); K2 on [B, S, H, D] views of one projection at
    the same rows (bit-equal to K1); K1 at Qwen2's 14 / 2 heads; K8 at 32 /
    32 heads of 96 (its wide form) and 14 / 2 heads of 64 (the split form)
    over 2145-row windows, the form and pieces in each line: each
    against its plain version at TOL / LSE_TOL / BWD_TOL / DELTA_TOL /
    DECODE_TOL, timed by CUDA graph replay beside its bound (FLOPs of the
    true D) and SDPA.
    (b) InternVL2-4B scoring, 2 chunks at full depth (24 + 32 layers) in
    bf16, W8A8, W8A8 with every feed fused, int8 and int4: launches per
    forward exactly (bf16: K1 56; W8A8: K1 56, K4a 48, K4b 24, K4c 24, with
    the fused feeds also K5a 64 and K5b 32; int8 / int4: K1 24, K2 32, K6 /
    K7 128 in the GEMM form), the fused-qkv launches by head shape
    (`tally_heads`), ms per chunk, peak; the readout against every kernel's
    plain version and a reference (fp32 forward; fp32-activation W8A8; the
    bf16 model of the dequantized weights) at phases 4-6's tolerances, and
    the quantized readouts' cosine to bf16.
    (c) `generate` in bf16, B = 4, P15_GEN_TOKENS greedy tokens: K8 32 a
    step, phase 8's checks. (d) phase 9's shared prefix (P = 4) on the 4B
    model. (e) phase 7's TRAIN_STEPS stage-2 LoRA steps of the 4B model at
    P15_TRAIN_VIDEOS videos, gradients against the plain path and fp32.
    (f) InternVL2-1B scoring in bf16 and W8A8 as (b), and its generation
    through the tied LM head as (c), K8 24 a step.
    (g) `cli.score.main` from a directory holding the 4B composite
    config.json (Phi-3 at P15_CLI_CUT layers per tower), the test tokenizer
    and the fp32 JAX tree of seed 0 as `params.safetensors`, two questions:
    scores bit-equal to the same call on a directory without weights (the
    model drawn from seed 0).

16. More than one card, on the one card there is (world 1, NCCL, a free
    port). (a) `cli/stage2_train.main` at `--model_scale 2b` (LoRA r = 8 in
    both towers, bf16, P16_VIDEOS of phase 10b's videos, batch P16_BATCH: 3
    steps, no eval) unwrapped in this process, then through `python -m
    torch.distributed.run --nproc_per_node 1` with `--mesh_fsdp 1` (this
    script as the rank, P16_CHILD: the trainer wraps the model in FSDP2):
    the losses of the two within 1e-5 relative (bit-equal expected, any
    difference printed); per run 288 K1 lse, 144 K3a, 144 K3b launches and
    no other attention kernel; the artifact and the last checkpoint; ms per
    step (steps 2-3), peak memory, the wrapped parameters' placements. (b)
    `models/loading.shard_for_inference` of the 2B model, bf16 and W8A8,
    in a process group of one built here: one `score_perspectives` chunk of
    phase 4's videos against the unwrapped model's within 1e-5 of the
    largest score (bit-equal printed); per chunk 48 K1 launches (W8A8: the
    `bsd` form, and 48 K4a, 24 K4b, 24 K4c, whose LayerNorm weights are
    views into FSDP2's all-gather buffer); ms and peak memory of both.

17. The `tensor` mesh axis (`parallel/tensor.py`) on the one card: NCCL
    refuses two ranks on one device, so the card holds the shards and the
    CPU tests the collectives. One InternViT-300M layer and one
    InternLM2-1.8B decoder layer at the 2B's full widths, bf16, weights from
    seed 0 (`p17_layers`), each rank's shard built group-less for tensor 2
    and 4 and run here, the partial outputs summed on the card and each
    row-parallel bias added once (`p17_sum`). (a) Forward, module by
    module (the ViT's attention and MLP on P17_VIT_FRAMES frames, the
    decoder's on P17_ROWS rows): each module's shard sum, before the
    residual, against the whole module within P17_MODULE_TOL relative L2,
    and the sum without shard 0's partial beyond it (the control); each
    shard's K1 launch against the plain attention at its local heads on the
    kernel's own input within P17_KERNEL_TOL, and the plain output with its
    heads rolled by one beyond it; K1 launches by head shape exactly one per
    shard at the local heads (`tally_heads`: ViT 8 / 8 or 4 / 4 of 64,
    decoder 8 / 4 or 4 / 2 of 128); ms of each shard's module against the
    whole module's. (b) The same layers with rank-LORA_RANK
    adapters (dropout 0.05, each rank's masks cut from the whole
    activation's) in a stage-2 step, forward and backward of (y . u): the
    shards' adapter gradients, gathered into the unsplit layout or summed,
    and both inputs' gradients against the whole layers' within
    TRAIN_GRAD_TOL; K1 lse, K3a, K3b one a shard at the local heads. (c) One
    decode step of the decoder's attention (B = 4) after a full-width
    prefill of P17_ROWS, on per-rank caches cut from the prefilled cache:
    against the whole step within DECODE_TOL; K8 one a shard at tensor 2
    (8 / 4 heads), none at tensor 4 (4 / 2 heads fail
    `decode_kernel_supported`: the two-part path, printed); ms per shard
    against the whole step.

18. Checkpoints in JAX's orbax layout and `w8a8_motion`. (a) The committed
    JAX-written tiny stage-1 checkpoint (`tests/data/orbax_stage1/`, one
    JAX step) read through `utils/orbax_format` and libzstd without JAX,
    orbax or tensorstore: every leaf's dtype, shape and SHA-256 against
    `tests/data/orbax_stage1.sha256.json`. (b) The 2B stage-1 trainer at
    the training CLI's batch (4 videos x 8 frames x 448 px, full depth):
    P18_STEPS steps, `CheckpointManager.save` (the whole TrainState, frozen
    towers included, as JAX writes it), P18_STEPS more; a fresh trainer
    whose weights are drawn from another seed restored from it and stepped
    P18_STEPS times: losses and every tensor against the straight run
    within P18_TOL (bit-equal expected, printed), the frozen ones
    bit-equal; save and restore seconds, GB on disk, GB/s; K1, K1 lse,
    K3a, K3b launched for each step after the restore (counts zeroed before
    the restore). (c) SlowFast-R50 + motion_mlp on the 2B chunk in bf16,
    with and without `Precision.w8a8_motion` on the same weights: the
    readout within P18_MOTION_TOL relative L2, ms per forward both ways,
    and one `torch._int_mm` call per switched pointwise conv.

Then one JSON line describing the kernels (the K1, K3, K4a-c and K8 entries
also with their launches on the paths of phases 7c, 12, 13, 14, 15, 16, 17 and 18; the
D = 96 and 14 / 2 forms of phase 15 as entries of their own), and last
{"ok": true, "device": {...}}. The line before them gives the whole run's
seconds. Imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import copy
import csv
import dataclasses
import gc
import io
import json
import os
import subprocess
import sys
import tempfile
import time
import warnings
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
# ... except where every row has one valid key (S = 1 or kv_valid = 1): there
# p = 1 and ds = 0, so dq and dk are 0 in exact arithmetic and are held to 0
# within a thousandth of dout's unit scale, far below what a fault in the
# backward would give
ZERO_GRAD_ATOL = 1e-3
# delta = rowsum(dout * out) as the backward's first launch writes it, against the fp32
# expression: both sum exact bf16 x bf16 products in fp32, in another order
DELTA_TOL = 1e-5
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
# quantize kernels vs plain: the row sums run in another order, rsqrt comes
# from other library code and the kernel's GELU computes 0.5 x (1 + tanh(u))
# as x / (1 + e^(-2u)), so y / s may land on the other side of a half
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
# same size before the sum over the window averages it out. The fused entry
# merges the current token into the unrounded fp32 state and rounds once,
# where JAX's merge_new_token takes the window's output rounded to bf16 and
# rounds again: a difference below out's own bf16 rounding.
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
    # the forward's tile borders (128 q rows per block, 128 or 176 keys per
    # K/V tile): non-causal Sq > Skv with kv_valid inside a tile, Sq < Skv
    # at G = 6 (internlm2-chat-20b's 48 / 8 heads), kv_valid = 1 at 25 heads
    # of 128, one query row
    "sq_gt_skv": (2, 300, 129, 16, 8, 64, False, 100, "bshd"),
    "sq_lt_skv_g6": (2, 127, 257, 48, 8, 128, False, None, "bhsd"),
    "kv1_h25": (2, 129, 129, 25, 25, 128, False, 1, "bshd"),
    "sq1": (3, 1, 129, 16, 8, 128, False, 100, "bshd"),
    # the backward's tile borders (key tiles of 128, 64 per warpgroup, q
    # tiles of 64; earlier: q tiles of 192 rows at D = 64, K/V tiles of 64)
    "s193_kv65_d64": (2, 193, 193, 8, 8, 64, False, 65, "bhsd"),
    "s65_causal": (2, 65, 65, 16, 8, 128, True, None, "bshd"),
}
SHAPES = {
    "vit": (32, 16, 16, 1032, 64, False, 1025),
    "llm": (4, 16, 8, 2113, 128, True, None),
    "ragged": (2, 4, 4, 200, 64, False, 150),
    # the forward's tile borders: one row, rows one short of and one past a
    # tile with kv_valid inside one, causal at ragged S, G = 6, kv_valid = 1,
    # 25 heads of 128
    "s1_causal": (4, 16, 8, 1, 128, True, None),
    "s127": (2, 16, 16, 127, 64, False, 100),
    "s129_causal": (2, 16, 8, 129, 128, True, None),
    "s257_causal_g6": (1, 48, 8, 257, 128, True, None),
    "kv1": (2, 16, 16, 257, 64, False, 1),
    "h25": (2, 25, 25, 300, 128, False, 257),
    # the backward's tile borders: rows one short of and one past a 64-row q
    # tile at D = 128, one past three at D = 64 with kv_valid one past a
    # 128-key tile, and (an earlier kernel's) one short of 192 rows
    "s191_causal_d64": (1, 8, 2, 191, 64, True, None),
    "s193_kv65": (2, 4, 4, 193, 64, False, 65),
    "s63": (2, 4, 4, 63, 128, False, None),
    "s65_causal": (2, 16, 8, 65, 128, True, None),
    # internlm2-chat-20b's attention (InternVL2-26B's decoder), 2 videos
    "llm_20b": (2, 48, 8, 2113, 128, True, None),
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
ODD_K = (2047, 4096)  # int4 pads a nibble, x loses its 16-byte rows: the unaligned form
# (M, K, N) across the weight-only forms' borders: M = 8 / 9 and 16 / 17 (the
# GEMV form's 8-row blocks), M = 64 / 65 (GEMV_MAX_ROWS: the GEMV form to the
# GEMM form), M = 127 / 128 / 129 with N = 255 / 256 / 257 (two of the GEMM's
# 128-channel tiles), M = 255 / 256 / 257 (its 256-row tiles) with N = 127 /
# 128 / 129, K = 64 (one K step), K = 160 (a ragged last step) and K = 100
# (rows off 16 bytes: the unaligned form)
WO_BORDERS = [(8, 2048, 2048), (9, 2048, 2048), (16, 2048, 2048), (17, 2048, 2048),
              (64, 2048, 2048), (65, 2048, 2048), (127, 2048, 255), (128, 2048, 256),
              (129, 2048, 257), (255, 2048, 127), (256, 2048, 128), (257, 2048, 129),
              (300, 64, 1024), (300, 160, 1024), (300, 100, 1024)]
# (M, K, N) where the GEMM form's schedule changes on 132 SMs, each through
# the wrapper, then a second launch and a CUDA graph replay bit-equal to the
# first: tile counts (256 rows x 128 channels) of 131, 132, 133, 143, 263,
# 264, 265, 527, 528 and 529, the 2B wo / w2's 544 (33 full m tiles and one
# of 4 rows, whose products run 64 wide), last m tiles of 100 and 200 rows
WO_GEMM_EDGES = [(33536, 64, 128), (2816, 256, 1536), (34048, 64, 128), (2816, 256, 1537),
                 (67328, 64, 128), (5632, 64, 1536), (13568, 64, 640), (7936, 64, 2176),
                 (8448, 64, 2048), (5888, 64, 2944), (PREFILL_ROWS, 2048, 2048),
                 (PREFILL_ROWS, 8192, 2048), (612, 256, 384), (456, 256, 384)]
# (K, N) of the other decoders' projections at the prefill's rows, the GEMM
# form: InternVL2-26B (internlm2-chat-20b), -4B (Phi-3-mini, fused qkv and
# gate_up), -1B (Qwen2-0.5B)
WO_OTHER = {"26b_wqkv": (6144, 8192), "26b_wo": (6144, 6144), "26b_w1": (6144, 16384),
            "26b_w2": (16384, 6144), "4b_qkv": (3072, 9216), "4b_o": (3072, 3072),
            "4b_gate_up": (3072, 16384), "4b_down": (8192, 3072), "1b_wqkv": (896, 1152),
            "1b_wo": (896, 896), "1b_w1": (896, 4864), "1b_w2": (4864, 896)}
L2_BYTES = 50e6
# fp8 decode matmul (K9) vs its plain version rounded to bf16, relative L2:
# both sum exact products (e4m3 x bf16) in fp32, so what is left is the
# summation order and one bf16 rounding
FP8_TOL = 1e-3
# the probe's decode matvecs of InternLM2-1.8B (K, N): wqkv, w1 / w3 fused, w2
FP8_SHAPES = {"wqkv": (2048, 4096), "w13": (2048, 16384), "w2": (8192, 2048)}
FP8_ROWS = (1, 4, 8)  # decode rows; 8 is the probe's
# The probe's error of K9 against the float product (largest difference over
# the largest value): e4m3 keeps 3 mantissa bits, and the plain version gives
# 2.6e-2 to 2.7e-2 at these shapes
FP8_PROBE_ERR = 5e-2
FP8_RAGGED = (3, 2050, 4100)  # (M, K, N): K off the 16-byte spans, N off the 16 channels
FP8_FIXED = (8, 64, 16)  # (M, K, N): one tile, one 64-byte step: a launch's fixed cost
EVAL_PERSPECTIVES = ("How would you rate the static quality of this video?",
                     "How would you rate the temporal smoothness of this video?")
# The fused eval (shared prefix, uint8 frames normalized on the card) against
# the solo stage-2 eval (every prompt in full, frames normalized on the host),
# both in fp32 through the plain attention: the largest score difference over
# the largest score and the readouts' relative L2. Only the summation order
# differs, so a fault in the fused path's wiring (the prefix, the padding,
# the ids layout) shows far above it (3.1e-6 and 4.4e-6 on an H100). In bf16
# the same comparison is held to READOUT_TOL / REF_RATIO at the readout and
# to EVAL_SCORE_TOL, the smoke's bf16 tolerance, at the score
EVAL_FP32_TOL = 1e-3
EVAL_SCORE_TOL = 3e-2
# --eval_w8a8 against the bf16 fused eval, largest score difference over the
# largest bf16 score: the relative part of tests/test_fused_eval.py's bound
# (0.15 x the largest score + 0.05; the 0.05 would swamp scores of ~2e-3)
W8A8_EVAL_DRIFT = 0.15
# phase 13b: the eval CLI's fused --eval_w8a8 scores against the same live
# model built outside the CLI and replayed on the batches the CLI scored, the
# largest difference over the largest score: the same build, kernels and
# inputs, so only run-to-run noise; the adapters merged before quantizing
# (the control) must land further away
LIVE_EVAL_TOL = 1e-3
# phase 13d: a quantized build's peak above the weights it leaves, in units of
# the model's largest fp32 tensor: that one tensor's fp32 draw, and the
# quantizer's temporaries of one block of rows (models/lora.QUANT_BLOCK
# values); never the model in fp32, at any depth
BUILD_OVER_LARGEST = 1.25


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


def rate(flops: float, bound: float, ms: float) -> dict:
    """Achieved TFLOP/s and the share of the bound at `ms` per call."""
    return dict(tflops=flops / ms / 1e9, bound_share=bound / ms)


def rate_text(flops: float, bound: float, ms: float) -> str:
    r = rate(flops, bound, ms)
    return f"{r['tflops']:.1f} TFLOP/s, {r['bound_share']:.1%} of the bound"


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


def check_attention(fa, device, shapes=SHAPES) -> dict:
    results = {}
    for name, shape in shapes.items():
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
        # device times by CUDA graph replay, the kernel's forms and SDPA in turn
        bsd = dict(out_layout="bsd", **kw)
        ms = graph_ms([lambda: fa.flash_attention_qkv(qkv, hq, hkv, **kw)] * 3, 10)
        ms_dense = graph_ms([lambda: fa.flash_attention_qkv(qkv, hq, hkv, **bsd)] * 3, 10)
        call_ms = time_ms(lambda: fa.flash_attention_qkv(qkv, hq, hkv, **kw), 20)
        plain_ms = time_ms(lambda: fa.plain_attention_qkv(qkv, hq, hkv, **kw), 5)
        plain_ms_dense = time_ms(lambda: fa.plain_attention_qkv(qkv, hq, hkv, **bsd), 5)
        with torch.no_grad():
            q, k, v = sdpa_views(qkv, shape)
            lib = sdpa(q, k, v, shape)
            lib_err = (lib.float() - want.float()).abs().max().item()
            library_ms = graph_ms([lambda: sdpa(q, k, v, shape)] * 3, 10)
        flops, nbytes = attention_work(shape)["fwd"]
        bound, bound_by = bound_ms(flops, nbytes)
        text = f"B={b} hq={hq} hkv={hkv} S={s} D={d} causal={causal} kv_valid={kv_valid}"
        results[name] = dict(
            shape=text, max_abs_err=err, ms=ms, call_ms=call_ms, plain_ms=plain_ms,
            bsd_max_abs_err=err_dense, bsd_ms=ms_dense, bsd_plain_ms=plain_ms_dense,
            bound_ms=bound, bound_by=bound_by, library_ms=library_ms,
            library_max_abs_err=lib_err, **rate(flops, bound, ms),
            bsd_tflops=rate(flops, bound, ms_dense)["tflops"],
            library_tflops=rate(flops, bound, library_ms)["tflops"],
        )
        phase("kernel", f"attention {name}: {text} max_abs_err bhsd {err:.3e} bsd "
              f"{err_dense:.3e} (atol=rtol={TOL}), bsd == bhsd transposed exactly; by graph "
              f"replay bhsd {ms:.4f} ms ({rate_text(flops, bound, ms)}), bsd {ms_dense:.4f} ms "
              f"({rate_text(flops, bound, ms_dense)}), SDPA {library_ms:.4f} ms "
              f"({rate_text(flops, bound, library_ms)}; max_abs_err to plain {lib_err:.3e}); "
              f"bhsd call by call {call_ms:.4f} ms; plain {plain_ms:.4f} / {plain_ms_dense:.4f} "
              f"ms; bound {bound:.4f} ms ({bound_by})")
    return results


def check_attention_training(fa, device, shapes=SHAPES) -> dict:
    """The forward with logsumexp and the backward kernel (its three launches:
    delta, the key tiles, dq's convert)."""
    results = {}
    for name, shape in shapes.items():
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
        one_key = min(s, kv_valid or s) == 1
        bwd_text = (f"rel L2 dq {rel['dq']:.3e} dk {rel['dk']:.3e} dv {rel['dv']:.3e} (tol "
                    f"{BWD_TOL})")
        if one_key:
            # one valid key per row: p = 1 and ds = dout.v - dout.out = 0, so dq and dk
            # are rounding noise on both sides and their relative L2 has no scale.
            # They are held to 0 instead; dv by relative L2
            zero = max(dqkv[:, parts[k]].abs().max().item() for k in ("dq", "dk"))
            if zero > ZERO_GRAD_ATOL:
                raise RuntimeError(f"{name}: dq / dk above {ZERO_GRAD_ATOL} where they are 0")
            bwd_text = (f"one valid key per row: max |dq|, |dk| {zero:.3e} (tol "
                        f"{ZERO_GRAD_ATOL}), rel L2 dv {rel['dv']:.3e} (tol {BWD_TOL})")
        if not all(rel[k] <= BWD_TOL for k in (("dv",) if one_key else parts)):
            raise RuntimeError(f"{name}: backward relative L2 {rel} above {BWD_TOL}")
        if kv_valid is not None and dqkv[:, hq:, kv_valid:].any():
            raise RuntimeError(f"{name}: dk/dv rows of masked keys are not exactly 0")
        del want, plain_out, plain_lse

        # the entry into given buffers: delta from its first launch; a second
        # run gives the same bits (dQ summed over the key tiles in a fixed order)
        delta, again = torch.empty_like(lse), torch.empty_like(dqkv)
        bwd_args = (qkv, out, dout, lse, delta, again, hq, hkv)
        fa.flash_attention_qkv_bwd_kernel(*bwd_args, **kw)
        torch.cuda.synchronize()
        delta_rel = relative_l2(delta, (dout.float() * out.float()).sum(-1))
        if delta_rel > DELTA_TOL:
            raise RuntimeError(f"{name}: delta relative L2 {delta_rel} above {DELTA_TOL}")
        if not torch.equal(again, dqkv):
            raise RuntimeError(f"{name}: a second run of the backward differs")
        ms_lse = graph_ms([lambda: fa.flash_attention_qkv_lse(qkv, hq, hkv, **kw)] * 3, 10)
        ms_bwd = graph_ms([lambda: fa.flash_attention_qkv_bwd_kernel(*bwd_args, **kw)] * 3, 10)
        # the eager expression the backward's first launch replaces
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
        bounds = {k: bound_ms(*work[k]) for k in ("fwd_lse", "bwd", "delta")}
        text = f"B={b} hq={hq} hkv={hkv} S={s} D={d} causal={causal} kv_valid={kv_valid}"
        results[name] = dict(
            shape=text, lse_max_abs_err=lse_err, rel_l2=rel, max_abs_err=err,
            delta_rel_l2=delta_rel,
            lse_ms=ms_lse, **{f"lse_{k}": v for k, v in
                              rate(work["fwd_lse"][0], bounds["fwd_lse"][0], ms_lse).items()},
            bwd_ms=ms_bwd, delta_eager_ms=ms_delta,
            **{f"bwd_{n}": v for n, v in rate(work["bwd"][0], bounds["bwd"][0], ms_bwd).items()},
            plain_lse_ms=plain_lse_ms, plain_bwd_ms=plain_bwd_ms,
            library_bwd_ms=library_bwd_ms, library_rel_l2=lib_rel,
            bounds={k: dict(bound_ms=v[0], bound_by=v[1]) for k, v in bounds.items()},
        )
        phase("kernel", f"attention training {name}: {text}: out bit-equal with and without "
              f"lse, lse max_abs_err {lse_err:.3e} (tol {LSE_TOL}); {bwd_text}, masked-key rows "
              f"exactly 0, delta rel L2 {delta_rel:.3e} (tol {DELTA_TOL}), second run bit-equal; "
              f"by graph replay fwd+lse {ms_lse:.4f} ms "
              f"({rate_text(work['fwd_lse'][0], bounds['fwd_lse'][0], ms_lse)}; plain "
              f"{plain_lse_ms:.4f}, bound {bounds['fwd_lse'][0]:.4f}), backward (delta, key "
              f"tiles, dq's convert) {ms_bwd:.4f} ms "
              f"({rate_text(work['bwd'][0], bounds['bwd'][0], ms_bwd)}; bound "
              f"{bounds['bwd'][0]:.4f}); the eager delta it replaced {ms_delta:.4f} ms (delta's "
              f"bound {bounds['delta'][0]:.4f}, {bounds['delta'][1]}), "
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


def check_feed_ties(qf, device) -> None:
    """Every producer on rows where y / s is a half-integer or an integer: q
    and s equal the exact rint(y / s), half to even, bit for bit (the
    quotient's shortcut must take the division on every tie)."""
    from aigv_assessor_torch.tools.quant_fuse_ab import PRODUCERS, tie_grid

    wrappers = {"identity": qf.quant_rows, "layernorm": qf.layernorm_quant,
                "gelu": qf.gelu_quant, "rmsnorm": qf.rmsnorm_quant,
                "silu_mul": qf.silu_mul_quant}
    for producer in PRODUCERS:
        x, extra, eps, q_want, s_want = tie_grid(producer, device)
        args = (x, *extra, eps) if producer in ("layernorm", "rmsnorm") else (x, *extra)
        q, s = wrappers[producer](*args)
        torch.cuda.synchronize()
        if not (torch.equal(q, q_want) and torch.equal(s, s_want)):
            raise RuntimeError(f"{producer} quantize on the tie grid: "
                               f"{int((q != q_want).sum())} int8 values differ from rint(y / s)")
    phase("kernel", f"quantize feeds on the tie grid ({', '.join(PRODUCERS)}): q and s "
          "bit-equal to rint(y / s)")


def check_quantizers_bit_equal(device) -> dict:
    """`ops/w8a8.quantize_rows` and `ops/kv_quant.quantize_kv_rows` on the
    card against the same calls on the CPU, on the same bf16 inputs: the 2B
    decoder's rows (4 x 2113 x 2048, one all-zero row) and a cache slice (4
    sequences x 2177 rows x 8 kv heads x 128): int8 values and fp32 scales
    bit-equal. Beside it, how many scales a division by the Python number
    127 (a product with the reciprocal on the card) would give otherwise."""
    from aigv_assessor_torch.ops import kv_quant, w8a8

    gen = torch.Generator().manual_seed(9)
    rows = (3.0 * torch.randn((4, 2113, 2048), generator=gen)).to(torch.bfloat16)
    rows[0, 0] = 0.0  # the 1e-8 floor
    cache = (3.0 * torch.randn((4, 2177, 8, 128), generator=gen)).to(torch.bfloat16)
    out = {}
    for name, fn, x in (("quantize_rows", w8a8.quantize_rows, rows),
                        ("quantize_kv_rows", kv_quant.quantize_kv_rows, cache)):
        q_card, s_card = (t.cpu() for t in fn(x.to(device)))
        q_cpu, s_cpu = fn(x)
        q_diff = int((q_card != q_cpu).sum())
        s_diff = int((s_card != s_cpu).sum())
        if q_diff or s_diff or q_card.dtype != torch.int8 or s_card.dtype != torch.float32:
            raise RuntimeError(f"{name}: the card's int8 values differ from the CPU's in {q_diff} "
                               f"places, its scales in {s_diff}")
        amax = x.to(device).float().abs().amax(dim=-1)
        by_number = int(((amax / 127.0).cpu() != amax.cpu() / torch.full_like(amax.cpu(), 127.0))
                        .sum())
        out[name] = dict(values=q_cpu.numel(), scales=s_cpu.numel(), scales_off_by_number=by_number)
    phase("kernel", f"quantizers on the card against the CPU, same bf16 inputs: quantize_rows "
          f"{tuple(rows.shape)} and quantize_kv_rows {tuple(cache.shape)}: int8 values and fp32 "
          f"scales bit-equal ({out['quantize_rows']['scales']} + "
          f"{out['quantize_kv_rows']['scales']} scales); dividing by the number 127 instead "
          f"would change {out['quantize_rows']['scales_off_by_number']} + "
          f"{out['quantize_kv_rows']['scales_off_by_number']} of them on this card")
    return out


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
            return graph_ms([call] * 3, 10), lib_err

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
    ms = graph_ms([lambda: fa.flash_attention(q, k, v, **kw)] * 3, 10)
    plain_ms = time_ms(lambda: fa.plain_flash_attention(q, k, v, **kw), 5)
    library_ms, lib_err = sdpa_ms(q, k, v, kw, want, "bshd")
    flops, nbytes = attention_work(SHAPES["llm"])["fwd"]
    bound, bound_by = bound_ms(flops, nbytes)
    results["llm"] = dict(flops=flops,
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
    flops, nbytes = attention_work(shape)["fwd"]
    bound, bound_by = bound_ms(flops, nbytes)
    for layout in ("bhsd", "bshd"):
        q, k, v = parts if layout == "bhsd" else (t.transpose(1, 2) for t in parts)
        kwl = dict(layout=layout, **kw)
        _, want, err, equal, diff = compare(f"vit {layout}", q, k, v, kwl, fused[layout])
        ms = graph_ms([lambda: fa.flash_attention(q, k, v, **kwl)] * 3, 10)
        plain_ms = time_ms(lambda: fa.plain_flash_attention(q, k, v, **kwl), 5)
        library_ms, lib_err = sdpa_ms(q, k, v, kw, want, layout)
        results[f"vit_{layout}"] = dict(flops=flops,
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
        if "ms" in r:
            r.update(rate(r["flops"], r["bound_ms"], r["ms"]))
            r["library_tflops"] = rate(r["flops"], r["bound_ms"], r["library_ms"])["tflops"]
        timed = (f"; by graph replay kernel {r['ms']:.4f} ms "
                 f"({rate_text(r['flops'], r['bound_ms'], r['ms'])}), SDPA "
                 f"{r['library_ms']:.4f} ms "
                 f"({rate_text(r['flops'], r['bound_ms'], r['library_ms'])}"
                 f"; max_abs_err to plain {r['library_max_abs_err']:.3e}); plain "
                 f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']})"
                 if "ms" in r else "")
        fused_text = ("" if r.get("equals_fused") is None else
                      f", bit-equal to the fused-qkv kernel: {r['equals_fused']} (max abs "
                      f"diff {r['max_abs_diff_to_fused']:.3e})")
        phase("kernel", f"three-tensor attention {name}: {r['shape']}: max_abs_err "
              f"{r['max_abs_err']:.3e} (atol=rtol={TOL}){fused_text}{timed}")
    return results


def check_weight_only(wo, device) -> dict:
    """The int8 and int4 matmuls against their plain versions: at the
    decoder's shapes with the prefill's rows (the GEMM form, and the
    unaligned form on the same inputs), at the decode sizes (the GEMV form,
    every weight read from device memory), at the LM head, at the borders of
    the forms and their tiles (each through the wrapper, and through every
    form that takes it) and at an odd K (the unaligned form). Times by CUDA
    graph replay."""
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

    def through(kernel, want_form, label):
        """The wrapper, checked to take `want_form`."""
        def run(x, q, scale):
            before = dict(kernel.form_launches)
            y = kernel(x, q, scale)
            took = [f for f in wo.FORMS if kernel.form_launches[f] != before[f]]
            if took != [want_form]:
                raise RuntimeError(f"{label}: the wrapper took the {took} form, expected "
                                   f"{want_form}")
            return y
        return run

    def form_runs(bits, form_of):
        """Every form that takes inputs of the form `form_of`: all three
        unless those are unaligned, which the GEMM form refuses."""
        forms = [f for f in wo.FORMS if f != "gemm" or form_of != "unaligned"]
        return [(f, lambda x, q, s, f=f: wo._launch_form(f, bits, x, q, s)) for f in forms]

    def work(bits, m, k, n):
        return 2.0 * m * n * k, 2 * m * k + n * ((k + 1) // 2 if bits == 4 else k) + 4 * n + 2 * m * n

    def cycled(fn, weights, iters=20):
        """Device ms per call, cycling over weight copies beyond the L2."""
        return graph_ms([lambda w=w: fn(w) for w in weights], iters)

    for bits, kernel, plain in ((8, wo.int8_matmul, wo.plain_int8_matmul),
                                (4, wo.int4_matmul, wo.plain_int4_matmul)):
        table = {}
        for name, (k, n, _) in PROJECTIONS.items():
            x, q, scale, deq = operands(bits, PREFILL_ROWS, k, n)
            rel, err = compare(f"int{bits} {name}", through(kernel, "gemm", f"int{bits} {name}"),
                               plain, x, q, scale)
            compare(f"int{bits} {name} unaligned form",
                    lambda *a: wo._launch_form("unaligned", bits, *a), plain, x, q, scale)
            bound, bound_by = bound_ms(*work(bits, PREFILL_ROWS, k, n))
            entry = dict(
                K=k, N=n, M=PREFILL_ROWS, form="gemm", rel_l2=rel, max_abs_err=err,
                ms=graph_ms([lambda: kernel(x, q, scale)] * 3, 10),
                unaligned_ms=graph_ms(
                    [lambda: wo._launch_form("unaligned", bits, x, q, scale)] * 3, 5),
                plain_ms=time_ms(lambda: plain(x, q, scale), 3, warmup=1),
                library_ms=graph_ms([lambda: torch.nn.functional.linear(x, deq)] * 3, 10),
                bound_ms=bound, bound_by=bound_by, decode={})
            # decode sizes: cycle over copies of the weight that together
            # exceed the L2 cache, as a decoder walking its layers finds them
            copies = int(L2_BYTES * 2 // q.numel()) + 1
            qs = [q] + [q.clone() for _ in range(copies - 1)]
            deqs = [deq] + [deq.clone() for _ in range(copies // 2)]
            for m in DECODE_ROWS:
                xm = x[:m].contiguous()
                rel_m, err_m = compare(f"int{bits} {name} M={m}",
                                       through(kernel, "gemv", f"int{bits} {name} M={m}"),
                                       plain, xm, q, scale)
                b_m, by_m = bound_ms(*work(bits, m, k, n))
                entry["decode"][m] = dict(
                    form="gemv", rel_l2=rel_m, max_abs_err=err_m, weight_copies=copies,
                    ms=cycled(lambda w: kernel(xm, w, scale), qs),
                    library_ms=cycled(lambda w: torch.nn.functional.linear(xm, w), deqs),
                    bound_ms=b_m, bound_by=by_m)
            del qs, deqs
            table[name] = entry
            dec = ", ".join(
                f"M={m}: rel L2 {r['rel_l2']:.3e}, kernel {r['ms'] * 1e3:.2f} us "
                f"({r['bound_ms'] / r['ms'] * 100:.0f}% of the bound), F.linear "
                f"{r['library_ms'] * 1e3:.2f} us, bound {r['bound_ms'] * 1e3:.2f} us "
                f"({r['bound_by']})" for m, r in entry["decode"].items())
            phase("kernel", f"int{bits} matmul {name} K={k} N={n} M={PREFILL_ROWS}: rel L2 to "
                  f"plain {rel:.3e} (tol {WO_TOL}), max_abs_err {err:.3e}, zero column exactly "
                  f"0; GEMM form {entry['ms']:.4f} ms "
                  f"({2e-9 * PREFILL_ROWS * k * n / entry['ms']:.1f} TFLOP/s, "
                  f"{bound / entry['ms'] * 100:.1f}% of the bound), unaligned form "
                  f"{entry['unaligned_ms']:.4f} ms, plain {entry['plain_ms']:.4f} ms, F.linear "
                  f"bf16 on the dequantized weight {entry['library_ms']:.4f} ms, bound "
                  f"{bound:.4f} ms ({bound_by}); decode, GEMV form, weights from device "
                  f"memory ({copies} copies): {dec}")
        # the LM head: N off every tile, rows of y off their 4-byte alignment
        k, n = LM_HEAD
        x, q, scale, deq = operands(bits, DECODE_ROWS[0], k, n)
        rel, err = compare(f"int{bits} LM head", through(kernel, "gemv", f"int{bits} LM head"),
                           plain, x, q, scale)
        b_h, by_h = bound_ms(*work(bits, DECODE_ROWS[0], k, n))
        table["lm_head"] = dict(
            K=k, N=n, M=DECODE_ROWS[0], form="gemv", rel_l2=rel, max_abs_err=err,
            ms=graph_ms([lambda: kernel(x, q, scale)] * 3, 10),
            library_ms=graph_ms([lambda: torch.nn.functional.linear(x, deq)] * 3, 10),
            bound_ms=b_h, bound_by=by_h)
        h = table["lm_head"]
        phase("kernel", f"int{bits} matmul LM head K={k} N={n} M={DECODE_ROWS[0]}: rel L2 {rel:.3e}, "
              f"GEMV form {h['ms']:.4f} ms, F.linear {h['library_ms']:.4f} ms, bound {b_h:.4f} ms "
              f"({by_h})")
        del x, q, scale, deq
        # the forms' borders: through the wrapper, then through every form
        borders = {}
        for m, k, n in WO_BORDERS:
            x, q, scale, _ = operands(bits, m, k, n)
            want_form = wo.weight_only_form(m, k, n, bits, x, q)
            label = f"int{bits} M={m} K={k} N={n}"
            rel, err = compare(label, through(kernel, want_form, label), plain, x, q, scale)
            row = dict(form=want_form, rel_l2=rel, max_abs_err=err, forms={})
            for form, fn in form_runs(bits, want_form):
                row["forms"][form] = compare(f"{label} {form} form", fn, plain, x, q, scale)[0]
            borders[f"{m}x{k}x{n}"] = row
        table["borders"] = borders
        phase("kernel", f"int{bits} matmul at the forms' borders (M, K, N: wrapper's form, rel "
              f"L2 of every form that takes it): " + "; ".join(
                  f"{key} {r['form']} " + ", ".join(f"{f} {v:.2e}" for f, v in r["forms"].items())
                  for key, r in borders.items()))
        # the GEMM form where its schedule changes: a rerun and a replay
        # bit-equal (the fp32 sums run in a fixed order)
        edges = {}
        for m, k, n in WO_GEMM_EDGES:
            x, q, scale, _ = operands(bits, m, k, n)
            label = f"int{bits} GEMM edge M={m} K={k} N={n}"
            rel, err = compare(label, through(kernel, "gemm", label), plain, x, q, scale)
            gemm = lambda: wo._launch_form("gemm", bits, x, q, scale)  # noqa: E731
            first, again = gemm(), gemm()
            static = torch.empty_like(first)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                static.copy_(gemm())
            graph.replay()
            torch.cuda.synchronize()
            if not (torch.equal(first, again) and torch.equal(first, static)):
                raise RuntimeError(f"{label}: a second launch or a graph replay differs")
            edges[f"{m}x{k}x{n}"] = dict(tiles=-(-m // 256) * -(-n // 128), rel_l2=rel,
                                         max_abs_err=err, bit_equal=True)
            del x, q, scale, first, again, static, graph
        table["gemm_edges"] = edges
        phase("kernel", f"int{bits} matmul, GEMM form where its schedule changes (M x K x N: "
              f"tiles, rel L2; each rerun and graph replay bit-equal): " + "; ".join(
                  f"{key}: {r['tiles']}, {r['rel_l2']:.2e}" for key, r in edges.items()))
        # the other decoders' projections at the prefill's rows
        others = {}
        for label, (k, n) in WO_OTHER.items():
            x, q, scale, deq = operands(bits, PREFILL_ROWS, k, n)
            rel, err = compare(f"int{bits} {label}", through(kernel, "gemm", label), plain, x, q,
                               scale)
            b_o, by_o = bound_ms(*work(bits, PREFILL_ROWS, k, n))
            others[label] = dict(
                K=k, N=n, M=PREFILL_ROWS, rel_l2=rel, max_abs_err=err,
                ms=graph_ms([lambda: kernel(x, q, scale)] * 3, 10),
                library_ms=graph_ms([lambda: torch.nn.functional.linear(x, deq)] * 3, 10),
                bound_ms=b_o, bound_by=by_o)
            del x, q, scale, deq
        table["other_models"] = others
        phase("kernel", f"int{bits} matmul, the GEMM form at the 26B / 4B / 1B decoders' "
              f"projections, M={PREFILL_ROWS} (ms, F.linear ms, bound ms): " + "; ".join(
                  f"{key} {r['ms']:.4f} / {r['library_ms']:.4f} / {r['bound_ms']:.4f}"
                  for key, r in others.items()))
        if bits == 4:
            k, n = ODD_K
            x, q, scale, _ = operands(bits, DECODE_ROWS[0], k, n)
            rel, err = compare("int4 odd K", through(kernel, "unaligned", "int4 odd K"), plain,
                               x, q, scale)
            table["odd_k"] = dict(K=k, N=n, M=DECODE_ROWS[0], form="unaligned", rel_l2=rel,
                                  max_abs_err=err)
            phase("kernel", f"int4 matmul odd K={k} N={n} M={DECODE_ROWS[0]}: unaligned form, "
                  f"rel L2 {rel:.3e}")
        results[bits] = table
        phase("kernel", f"int{bits} matmul against the plain version rounded to bf16, worst of "
              f"{len(shares)} comparisons: {max(u for u, _ in shares):.3e} of the elements "
              f"differ (tol {WO_UNEQUAL_SHARE}), {max(b for _, b in shares):.3e} by more than "
              f"one bf16 ulp (tol {WO_ULP_SHARE})")
        shares.clear()
    return results


def fp8_split_borders(sms: int) -> list:
    """K9's split borders on a card of `sms` SMs, (M, K, N): tile counts on
    either side of the SM count and of twice it, where the plan's split (8
    or 16 warps an item) and its streams change, at K = 8192; K = 8256 (129
    steps, which neither split divides), K below one step, N below one tile,
    M across the 8-row blocks."""
    tiles = (sms // 2, sms - 1, sms, sms + 1, 2 * sms - 1, 2 * sms, 2 * sms + 1)
    return ([(m, 8192, 16 * t) for m in (1, 8) for t in tiles]
            + [(8, 8256, 2048), (17, 8256, 2064), (1, 63, 15), (9, 100, 3), (5, 17, 40)])


def check_fp8(f8, device) -> dict:
    """The fp8 decode matmul against its plain version at the probe's shapes
    and decode rows, at a ragged shape and at every split border, through the
    wrapper and each of its two forms by name (`stream` where the rows start
    on 16 bytes), on a weight that holds every finite e4m3 code, with an
    all-zero channel exactly 0, a second launch and a CUDA graph replay
    bit-equal to the first; timed by CUDA graph replay over weight copies
    that together exceed the L2 cache (the wrapper and each form), beside its
    byte bound, the plain version and `F.linear` on the bf16 weight
    dequantized beforehand, and at FP8_FIXED (no weight to stream: the fixed
    cost of a launch)."""
    results = {}
    gen = torch.Generator(device=device).manual_seed(8)
    nan_bytes = torch.tensor([0x7F, 0xFF], dtype=torch.uint8, device=device)
    sms = torch.cuda.get_device_properties(device).multi_processor_count

    def forms_of(k):  # the forms that take rows of K bytes (and 2K of x)
        return f8.FORMS if k % 16 == 0 else ("tiles",)

    def held(label, m, k, n, x, w8, scale, zero_channel=None):
        """The wrapper and every form that takes the shape against the plain
        version -> (the wrapper's y, plain y, worst rel L2, plan, form)."""
        want = f8.plain_fp8_matmul(x, w8, scale)
        plan = f8.launch_plan(m, n, k)
        if plan != f8.matvec_plan(m, n, k, sms=sms):
            raise RuntimeError(f"fp8 {label}: the launch's plan {plan} is not the mirror's "
                               f"{f8.matvec_plan(m, n, k, sms=sms)}")
        form = f8.fp8_form(m, k, n, x, w8, sms)
        worst, got = 0.0, None
        for how in ("wrapper",) + forms_of(k):
            def run():
                if how == "wrapper":
                    return f8.fp8_matmul(x, w8, scale)
                return f8._launch_form(how, x, w8, scale)
            y, again = run(), run()
            torch.cuda.synchronize()
            rel = relative_l2(y.float(), want.float())
            if not (torch.isfinite(y).all() and rel <= FP8_TOL):
                raise RuntimeError(f"fp8 {label} M={m} K={k} N={n} {how} ({plan}): relative L2 "
                                   f"to the plain version {rel} above {FP8_TOL}")
            if zero_channel is not None and y[:, zero_channel].any():
                raise RuntimeError(f"fp8 {label} {how}: an all-zero channel is not exactly 0")
            if not torch.equal(y, again):
                raise RuntimeError(f"fp8 {label} {how}: a second launch differs from the first")
            worst = max(worst, rel)
            got = y if how == "wrapper" else got
        return got, want, worst, plan, form

    cases = [(name, m, k, n) for name, (k, n) in FP8_SHAPES.items() for m in FP8_ROWS]
    cases += [("ragged", *FP8_RAGGED), ("fixed", *FP8_FIXED)]
    for name, m, k, n in cases:
        w = torch.randn((n, k), generator=gen, device=device) * 0.02
        w[n // 2] = 0.0
        w8, scale = f8.quantize_weight_fp8(w)
        if torch.isin(w8.view(torch.uint8), nan_bytes).any():
            raise RuntimeError(f"fp8 {name}: the quantized weight holds a NaN byte")
        deq = f8.dequantize_weight_fp8(w8, scale, torch.bfloat16)
        x = torch.randn((m, k), generator=gen, device=device).to(torch.bfloat16)
        got, want, rel, plan, form = held(name, m, k, n, x, w8, scale, n // 2)
        flops = 2.0 * m * n * k
        nbytes = n * k + 2 * m * k + 2 * m * n + 4 * n
        bound, bound_by = bound_ms(flops, nbytes)
        copies = int(2 * L2_BYTES // (n * k)) + 1 if name != "fixed" else 1
        ws = [(w8, scale, deq)] + [(w8.clone(), scale, deq.clone()) for _ in range(copies - 1)]
        ws = ws if copies > 1 else ws * 20  # the fixed cost: one weight, 20 launches
        err = (got.float() - want.float()).abs().max().item()
        r = dict(M=m, K=k, N=n, rel_l2=rel, max_abs_err=err, weight_copies=copies, form=form,
                 split=plan.split, streams=plan.streams, bound_ms=bound, bound_by=bound_by,
                 ms=graph_ms([lambda c=c: f8.fp8_matmul(x, c[0], c[1]) for c in ws], 20),
                 form_ms={how: graph_ms([lambda c=c, h=how: f8._launch_form(h, x, c[0], c[1])
                                         for c in ws], 20) for how in forms_of(k)},
                 plain_ms=graph_ms([lambda c=c: f8.plain_fp8_matmul(x, c[0], c[1])
                                    for c in ws[:2]], 5),
                 library_ms=graph_ms([lambda c=c: torch.nn.functional.linear(x, c[2])
                                      for c in ws], 20))
        results[f"{name}_m{m}" if name in FP8_SHAPES else name] = r
        del ws
        phase("kernel", f"fp8 matmul (K9) {name} M={m} K={k} N={n}: the {form} form (stream "
              f"plan {plan.streams} streams of {plan.split} warps), worst rel L2 to plain "
              f"{rel:.3e} (tol {FP8_TOL}), no NaN byte, the zero channel 0, second launches "
              f"bit-equal; {r['ms'] * 1e3:.2f} us per launch (graph replay, {copies} weight "
              f"copies; by form " + ", ".join(f"{h} {t * 1e3:.2f}" for h, t in r['form_ms'].items())
              + f"), bound {bound * 1e3:.2f} us ({bound_by}, {bound / r['ms'] * 100:.0f}%), "
              f"F.linear bf16 {r['library_ms'] * 1e3:.2f} us, plain {r['plain_ms'] * 1e3:.2f} us")
    borders = {}
    for m, k, n in fp8_split_borders(sms):
        w = torch.randn((n, k), generator=gen, device=device) * 0.02
        w[n // 2] = 0.0
        w8, scale = f8.quantize_weight_fp8(w)
        x = torch.randn((m, k), generator=gen, device=device).to(torch.bfloat16)
        _, _, rel, plan, form = held("border", m, k, n, x, w8, scale, n // 2)
        borders[f"{m}x{k}x{n}"] = dict(form=form, split=plan.split, streams=plan.streams,
                                       rel_l2=rel)
    if {b["split"] for b in borders.values()} != {8, 16} or \
            {b["form"] for b in borders.values()} != set(f8.FORMS):
        raise RuntimeError(f"fp8 split borders: splits and forms {borders}")
    results["borders"] = borders
    # every finite e4m3 code in every channel, at random scales; a graph replay
    codes = torch.tensor([c for c in range(256) if c not in (0x7F, 0xFF)], dtype=torch.uint8)
    n, k = 272, 2048
    i = torch.arange(n * k)
    w8 = codes[(7 * i + i // k) % codes.numel()].view(n, k).to(device).view(torch.float8_e4m3fn)
    scale = torch.rand(n, generator=gen, device=device) * 1e-3 + 1e-4
    for m in (1, 8):
        x = torch.randn((m, k), generator=gen, device=device).to(torch.bfloat16)
        _, _, rel, _, _ = held("every code", m, k, n, x, w8, scale)
        for how in f8.FORMS:
            y = f8._launch_form(how, x, w8, scale)
            static = torch.empty_like(y)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                static.copy_(f8._launch_form(how, x, w8, scale))
            graph.replay()
            torch.cuda.synchronize()
            if not torch.equal(static, y):
                raise RuntimeError(f"fp8 every code M={m} {how}: a graph replay differs from the "
                                   f"eager launch")
        results[f"every_code_m{m}"] = dict(rel_l2=rel, graph_replay_bit_equal=True)
    # the in-kernel convert bit for bit: x the identity's first 8 rows and
    # scale 1 give y[m, n] = w8[n, m] as bf16; the first 8 columns hold every
    # finite code
    n, k = 256, 2048
    idx = torch.arange(n)[:, None] + 7 * torch.arange(k)[None, :]
    w8 = codes[idx % codes.numel()].to(device).view(torch.float8_e4m3fn)
    x = torch.eye(8, k, device=device).to(torch.bfloat16)
    for how in f8.FORMS:
        y = f8._launch_form(how, x, w8, torch.ones(n, device=device))
        if not torch.equal(y, w8[:, :8].to(torch.bfloat16).t()):
            raise RuntimeError(f"fp8: the {how} form's convert differs from w8.to(bfloat16)")
    phase("kernel", f"fp8 matmul (K9) at {len(borders)} split borders (splits 8 and 16, both "
          f"forms; worst rel L2 {max(b['rel_l2'] for b in borders.values()):.3e}) and on every "
          f"finite e4m3 code (rel L2 {results['every_code_m8']['rel_l2']:.3e}): within "
          f"{FP8_TOL}, the launches' plans the mirror's, second launches and graph replays "
          f"bit-equal; both forms' convert of every finite code bit-equal to w8.to(bfloat16)")
    return results


def run_fp8_probe(f8, wo, smi: str) -> dict:
    """Phase 3b, the K9 path: `tools/fp8_decode_probe.run`, the port of the
    probe, with the counts set to 0 just before it."""
    from aigv_assessor_torch.tools import fp8_decode_probe as probe

    f8.fp8_matmul.launches = wo.int4_matmul.launches = 0
    report = probe.run(iters=10, verbose=False)
    counts = {"fp8_matmul": f8.fp8_matmul.launches, "int4_matmul": wo.int4_matmul.launches}
    if not all(counts.values()):
        raise RuntimeError(f"fp8 probe: launches {counts}, every candidate kernel must run")
    errs = {k: v for k, v in report.items() if k.endswith("_pallas_fp8_rel_err")}
    if not all(v <= FP8_PROBE_ERR for v in errs.values()):
        raise RuntimeError(f"fp8 probe: relative errors against the float product {errs}")
    table = "; ".join(
        f"{name} M=8: " + ", ".join(f"{c} {report[f'{name}_{c}_us']:.2f} us "
                                    f"({report[f'{name}_{c}_gbps']:.0f} GB/s)"
                                    for c in probe.WEIGHT_BYTES)
        for name in probe.SHAPES)
    phase("probe", f"tools/fp8_decode_probe.run: launches {counts}; {table}; fp8 rel err "
          f"{ {k: f'{v:.2e}' for k, v in errs.items()} } [{smi}]")
    return dict(counts=counts, report=report)


def relative_l2(x: torch.Tensor, y: torch.Tensor) -> float:
    return ((x - y).norm() / y.norm()).item()


def run_train_slice(cfg, device, ids, mask, px_u8, rng, per_forward: int, smi: str, *,
                    name: str = "InternVL2-2B", tally: dict | None = None) -> tuple:
    """Phase 7 (and 15e) -> (launches of each attention kernel form over the
    TRAIN_STEPS steps, ms of the last step, peak GiB). per_forward: attention
    layers of one forward. `tally`, where given, receives the fused-qkv
    kernels' launches of the steps by form and head shape (`tally_heads`)."""
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
                     fa.flash_attention_qkv_bwd_kernel)
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
        with tally_heads(fa) as by_heads:
            t0 = time.perf_counter()
            train_steps(model, [batch], tc, trainer=trainer)  # step 1
            torch.cuda.synchronize()
            step1_ms = (time.perf_counter() - t0) * 1e3
            towers = (model.vision_model.layers, model.language_model.layers)
            ends = [m for layers in towers for layer in (layers[0], layers[-1])
                    for m in layer.modules() if hasattr(m, "lora_b")]
            # four adapted projections in a ViT layer, five in InternLM2's, four in Phi-3's
            llm_projections = 4 if cfg.llm.architecture == "Phi3ForCausalLM" else 5
            if (len(ends) != 2 * 4 + 2 * llm_projections
                    or not all(m.lora_b.any() for m in ends)):
                raise RuntimeError("a lora_b of a first or last layer is still zero after step 1")
            t0 = time.perf_counter()
            train_steps(model, [batch] * (TRAIN_STEPS - 1), tc, trainer=trainer)
            torch.cuda.synchronize()
            later_ms = (time.perf_counter() - t0) * 1e3 / (TRAIN_STEPS - 1)
        if tally is not None:
            tally.update(by_heads)
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
            "flash_attention_qkv_bwd_kernel": per_forward * TRAIN_STEPS}
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
                                                                   per_forward]:
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
    phase("slice", f"train {name} stage 2, LoRA r={LORA_RANK} both towers, bf16 with "
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
    return train_counts, steady_ms, peak_train


def check_decode_attention(dec, two_part, device, shapes=DECODE_SHAPES,
                           timed_shapes=("path", "ragged")) -> dict:
    """The decode-attention kernel against its plain version at `shapes`,
    merged against `two_part_cached_attention`, and timed at the
    `timed_shapes` (with short windows too at the path shape)."""
    results = {}
    for name, (b, hq, hkv, d, max_len, end_i, starts_t) in shapes.items():
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
        before = dec.cached_decode_attention.launches
        fused = dec.cached_decode_attention(q[:, None], k_new, v_new, ck_nan, cv_nan, end,
                                            starts=starts)
        torch.cuda.synchronize()
        if dec.cached_decode_attention.launches != before + 1 or not torch.isfinite(fused).all():
            raise RuntimeError(f"decode attention {name}: the fused entry did not launch once, "
                               "or read a row outside the window")
        w_fused = dec.plain_cached_decode_attention(q[:, None], k_new, v_new, ck, cv, end,
                                                    starts=starts)
        fused_err = (fused.float() - w_fused.float()).abs().max().item()
        torch.testing.assert_close(fused.float(), w_fused.float(), atol=DECODE_TOL,
                                   rtol=DECODE_TOL)
        merged = dec.cached_decode_attention(q[:, None], k_new, v_new, ck, cv, end, kv_mask)
        want = two_part(q[:, None], k_new, v_new, ck, cv, end_i, kv_mask)
        merged_err = (merged.float() - want.float()).abs().max().item()
        torch.testing.assert_close(merged.float(), want.float(), atol=DECODE_TOL, rtol=DECODE_TOL)
        if name == "path":  # no state kept between launches: a graph replays it as it is
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                replayed = dec.cached_decode_attention(q[:, None], k_new, v_new, ck, cv, end,
                                                       starts=starts)
            for _ in range(3):
                replayed.zero_()
                graph.replay()
                torch.cuda.synchronize()
                if not torch.equal(replayed, merged):
                    raise RuntimeError("decode attention: a replayed fused launch differs from "
                                       "the eager one")
            del graph
        n_rows = int(inside.sum())
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        nsplit = dec._splits(b, hkv, max_len, sms)
        r = dict(shape=f"B={b} hq={hq} hkv={hkv} D={d} max_len={max_len} end={end_i} "
                 f"starts={list(starts_t)}", nsplit=nsplit,
                 form="wide" if dec._wide(b, hkv, nsplit, sms) else "split",
                 rows=n_rows, max_abs_err=max(err, fused_err),
                 window_max_abs_err=err, fused_max_abs_err=fused_err,
                 merged_max_abs_err=merged_err,
                 m_max_rel_err=((m - w_m).abs() / w_m.abs().clamp_min(1e-6)).max().item(),
                 l_max_rel_err=((l - w_l).abs() / w_l.abs().clamp_min(1e-6)).max().item())
        if name in timed_shapes:
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
                lambda lk, lv: dec.cached_decode_attention(q[:, None], k_new, v_new, lk, lv, end,
                                                           starts=starts), 20)
            r["plain_ms"], _ = cycle(
                lambda lk, lv: dec.plain_cached_decode_attention(q[:, None], k_new, v_new, lk, lv,
                                                                 end, starts=starts))
            r["window_ms"], r["window_eager_ms"] = cycle(
                lambda lk, lv: dec.decode_attention(q, lk, lv, starts, end), 20)
            r["window_plain_ms"], _ = cycle(
                lambda lk, lv: dec.plain_decode_attention(q, lk, lv, starts, end))
            r["window_merge_ms"], r["window_merge_eager_ms"] = cycle(
                lambda lk, lv: dec.merge_new_token(*dec.decode_attention(q, lk, lv, starts, end),
                                                   q, k_new, v_new), 20)
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
            # the fused entry: each K and V row of the windows read once, q
            # and the current token's k and v read and out written once; 2
            # products of D terms per row and query head, in fp32 outside the
            # tensor cores (67 TFLOP/s). The window alone writes m and l
            # instead of reading k and v.
            nbytes = n_rows * hkv * d * 2 * 2 + 2 * b * hq * d * 2 + 2 * b * hkv * d * 2
            window_bytes = n_rows * hkv * d * 2 * 2 + 2 * b * hq * d * 2 + 2 * b * hq * 4
            t_ops = 4.0 * n_rows * hq * d / 67e12 * 1e3
            for key, nb in (("", nbytes), ("window_", window_bytes)):
                t_bytes = nb / PEAK_BYTES * 1e3
                r.update({f"{key}bound_ms": max(t_bytes, t_ops), f"{key}bytes": nb,
                          f"{key}bound_by": "bytes" if t_bytes >= t_ops else "operations"})
        if name == "path":
            short = (end - DECODE_SHORT).expand(b).contiguous()
            r["short_ms"], _ = cycle(
                lambda lk, lv: dec.cached_decode_attention(q[:, None], k_new, v_new, lk, lv, end,
                                                           starts=short), 20)
            if not r["short_ms"] <= r["ms"]:
                raise RuntimeError(f"decode attention: windows of {DECODE_SHORT} rows took "
                                   f"{r['short_ms']:.4f} ms, full windows {r['ms']:.4f} ms")
        results[name] = r
        timed = ("" if "ms" not in r else
                 f"; device time by graph replay (and call by call, host included): fused "
                 f"entry {r['ms'] * 1e3:.1f} ({r['eager_ms'] * 1e3:.1f}) us (bound "
                 f"{r['bound_ms'] * 1e3:.2f} us, {r['bound_by']}, {r['bytes']} bytes: "
                 f"{r['bound_ms'] / r['ms'] * 100:.1f}%), plain {r['plain_ms'] * 1e3:.1f} us; "
                 f"window alone {r['window_ms'] * 1e3:.1f} ({r['window_eager_ms'] * 1e3:.1f}) us "
                 f"(bound {r['window_bound_ms'] * 1e3:.2f} us: "
                 f"{r['window_bound_ms'] / r['window_ms'] * 100:.1f}%), plain "
                 f"{r['window_plain_ms'] * 1e3:.1f} us; window + eager merge_new_token "
                 f"{r['window_merge_ms'] * 1e3:.1f} ({r['window_merge_eager_ms'] * 1e3:.1f}) us, "
                 f"merge_new_token alone {r['merge_ms'] * 1e3:.1f} "
                 f"({r['merge_eager_ms'] * 1e3:.1f}) us; eager two_part_cached_attention "
                 f"{r['two_part_ms'] * 1e3:.1f} ({r['two_part_eager_ms'] * 1e3:.1f}) us, SDPA "
                 f"{r['library_ms'] * 1e3:.1f} ({r['library_eager_ms'] * 1e3:.1f}) us "
                 f"(max_abs_err to plain {r['library_max_abs_err']:.3e})" +
                 (f", windows of {DECODE_SHORT} rows {r['short_ms'] * 1e3:.1f} us"
                  if "short_ms" in r else ""))
        phase("kernel", f"decode attention {name}: {r['shape']} ({n_rows} rows; {r['form']} "
              f"form, {nsplit} piece(s) a window): window out "
              f"max_abs_err {err:.3e}, fused entry vs plain_cached_decode_attention "
              f"{fused_err:.3e} (atol=rtol={DECODE_TOL}), m / l max rel err "
              f"{r['m_max_rel_err']:.2e} / {r['l_max_rel_err']:.2e} (tol {DECODE_ML_RTOL}), rows "
              f"outside the windows NaN and not read, fused entry vs two_part_cached_attention "
              f"{merged_err:.3e}{timed}")
    return results


def run_generation(cfg, device, ids, px_u8, smi, *, label: str, n_llm: int, n_vit: int,
                   bf16_logits=None, name: str = "InternVL2-2B", gen_tokens: int = GEN_TOKENS,
                   **flags) -> dict:
    """Phase 8 (and 15c, 15f) for one precision -> launches of the main
    path's run, times, and the kernel path's teacher-forced logits."""
    from aigv_assessor_torch.cli.score import build_serving_model
    from aigv_assessor_torch.core.precision import Precision
    from aigv_assessor_torch.models import internlm2
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
    max_len = seq + gen_tokens
    gcfg = GenerationConfig(max_new_tokens=gen_tokens, eos_token_id=-1)  # never stops
    counters = (dec.cached_decode_attention, dec.decode_attention, wo.int8_matmul,
                wo.int4_matmul, fa.flash_attention_qkv, fa.flash_attention)
    merges = []  # calls of the eager merge, which the card's path no longer makes
    real_merge = dec.merge_new_token
    with torch.inference_mode():
        pv = resize_normalize(px_u8, size=IMAGE, dtype=dtype)
        generate(model, None, ids, pv, gcfg=GenerationConfig(max_new_tokens=2, eos_token_id=-1),
                 with_motion=True)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        # the main path, every count at 0 just before it
        for c in counters:
            c.launches = 0
        wo.int8_matmul.form_launches = dict.fromkeys(wo.FORMS, 0)
        with mock.patch.object(dec, "merge_new_token",
                               lambda *a: merges.append(1) or real_merge(*a)):
            t0 = time.perf_counter()
            tokens = generate(model, None, ids, pv, gcfg=gcfg, with_motion=True)
            total_ms = (time.perf_counter() - t0) * 1e3
        counts = {c.__name__: c.launches for c in counters}
        forms = dict(wo.int8_matmul.form_launches)
        peak_gib = torch.cuda.max_memory_allocated(device) / 2**30
    steps = gen_tokens - 1
    per_pass = 5 * n_llm + 1  # the projections and the LM head
    want = {"cached_decode_attention": 0 if kv_int8 else n_llm * steps, "decode_attention": 0,
            "int8_matmul": per_pass * (1 + steps) if int8 else 0, "int4_matmul": 0,
            "flash_attention_qkv": n_vit, "flash_attention": 0}
    if counts != want or merges:
        raise RuntimeError(f"generation {label}: launches {counts}, expected {want}; "
                           f"merge_new_token called {len(merges)} times, expected 0")
    # int8: the prefill's 4 x 2113 rows take the GEMM form, every decode
    # step's 4 rows the GEMV form
    want_forms = dict.fromkeys(wo.FORMS, 0)
    if int8:
        want_forms.update(gemm=per_pass, gemv=per_pass * steps)
    if forms != want_forms:
        raise RuntimeError(f"generation {label}: int8 matmul forms {forms}, expected "
                           f"{want_forms}")
    if tokens.shape != (batch, gen_tokens) or tokens.min() < 0 or tokens.max() >= cfg.llm.vocab_size:
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

        before = dec.cached_decode_attention.launches
        k_logits, k_cache = forced_logits(model, embeds)
        if dec.cached_decode_attention.launches - before != (0 if kv_int8 else n_llm * FORCED):
            raise RuntimeError(f"generation {label}: the forced steps did not go through the "
                               "decode-attention kernel once per layer")
        kernel, launched = dec.cached_decode_attention, dec.cached_decode_attention.launches
        with mock.patch.object(internlm2, "cached_decode_attention",
                               dec.plain_cached_decode_attention):
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
        f_logits = lm.logits(hidden[:, seq - 1 :]).float()
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
    phase("slice", f"generation {label} {name}, {batch} x {seq}-token prompt with motion, "
          f"{gen_tokens} new tokens greedy: launches {counts} ({n_llm} fused decode attention "
          f"per step, merge_new_token called {len(merges)} times), int8 matmul forms {forms}; "
          f"generate {total_ms:.1f} ms; prefill "
          f"{prefill_ms:.1f} ms, decode step {step_ms:.3f} ms, {batch * 1e3 / step_ms:.1f} "
          f"tokens/s; cache {cache_bytes} bytes "
          f"for {max_len} rows; peak {peak_gib:.2f} GiB allocated; forced logits rel L2 kernel "
          f"vs plain decode attention {rel_plain:.3e}, vs cache-free forward {rel_free:.3e} "
          f"(tol {DECODE_LOGITS_TOL}, cache-free {free_tol}){ref_text}; argmax agrees on {int(agree.sum())} of "
          f"{agree.numel()} ({int(clear.sum())} with a clear margin, all agree); cache rows vs "
          f"capture_kv rows rel L2 {rows_rel:.3e}, layer 0 {rows0_rel:.3e}; tokens of sample 0 "
          f"{tokens[0, :8].tolist()} [{smi}]")
    del model
    torch.cuda.empty_cache()
    return dict(counts=counts, forms=forms, prefill_ms=prefill_ms, step_ms=step_ms,
                total_ms=total_ms, peak_gib=peak_gib, cache_bytes=cache_bytes, logits=k_logits)


def run_shared_prefix(cfg, device, videos, rng, smi, *, n_vit: int, n_llm: int,
                      name: str = "InternVL2-2B") -> dict:
    """Phase 9 (and 15d): P prompts per video through `score_chunks`, with
    and without the shared prefix."""
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
    counters = (fa.flash_attention_qkv, fa.flash_attention, dec.decode_attention,
                dec.cached_decode_attention)
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
                "decode_attention": 0, "cached_decode_attention": 0}
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
    phase("slice", f"shared prefix bf16 {name}, {PERSPECTIVES} prompts of {seq} tokens "
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


def write_eval_metas(folder: str) -> tuple:
    """The CLI's videos (`write_cli_videos`) under one annotation per
    EVAL_PERSPECTIVES entry, answers with quality words and mos from a seed,
    and a meta JSON for each -> the metas' paths."""
    write_cli_videos(folder)
    videos = sorted(f for f in os.listdir(folder) if f.endswith((".mp4", ".gif")))
    rng = np.random.default_rng(11)
    words = ("excellent", "good", "fair", "poor", "bad")
    metas = []
    for p, question in enumerate(EVAL_PERSPECTIVES):
        rows = [{"video": v, "mos": float(rng.uniform(10, 90)), "conversations": [
            {"from": "human", "value": question},
            {"from": "gpt", "value": f"The quality of the video is {words[(i + p) % 5]}."}]}
            for i, v in enumerate(videos)]
        ann = os.path.join(folder, f"eval_p{p + 1}.jsonl")
        with open(ann, "w") as f:
            f.writelines(json.dumps(r) + "\n" for r in rows)
        meta = os.path.join(folder, f"meta_p{p + 1}.json")
        with open(meta, "w") as f:
            json.dump({f"persp{p + 1}": {"root": folder, "annotation": ann, "repeat_time": 1,
                                         "data_augment": False}}, f)
        metas.append(meta)
    return tuple(metas)


def run_eval_clis(device, smi, *, n_vit: int, n_llm: int) -> dict:
    """Phase 10b: the stage-1 and stage-2 eval CLIs (`cli/stage1_eval.main`,
    `cli/stage2_eval.main`) on a meta file at 2B, weights from the CLIs' seed,
    the test tokenizer; the stage-2 runs with the score head's last layer made
    non-negative and its bias 0, so that the scores are not all 0 and follow
    the readout, which is recorded. -> each run's wall time (s)."""
    from aigv_assessor_torch.cli import common, stage1_eval, stage2_eval
    from aigv_assessor_torch.ops import decode_attention as dec
    from aigv_assessor_torch.ops import flash_attention as fa
    from aigv_assessor_torch.ops import quant_fuse as qf

    build = common.build_serving_model
    readouts = []

    def opened_head(*args, **kw):
        model = build(*args, **kw)
        if hasattr(model, "mlpscore"):
            last = getattr(model.mlpscore, f"fc{model.mlpscore.num_layers}")
            with torch.no_grad():
                last.weight.abs_()
                last.bias.zero_()
            model.mlpscore.register_forward_hook(lambda _m, args, _out: readouts.append(
                args[0].detach().float().reshape(-1, args[0].shape[-1])))
        return model

    counters = (fa.flash_attention_qkv, fa.flash_attention, fa.flash_attention_qkv_lse,
                dec.decode_attention, dec.cached_decode_attention, qf.layernorm_quant,
                qf.gelu_quant, qf.quant_rows, qf.rmsnorm_quant, qf.silu_mul_quant)
    # the W8A8 feeds at JAX's default (`AIGV_FUSE_QUANT` unset: the ViT's)
    env = {k: v for k, v in os.environ.items() if not k.startswith("AIGV_")}
    n_videos = CLI_VIDEOS + 1
    batches = -(-n_videos // BATCH)
    p_count = len(EVAL_PERSPECTIVES)
    with tempfile.TemporaryDirectory() as d:
        metas = write_eval_metas(d)
        runs = {}

        def run(label, fn, meta, *extra, launches=None, fp32=False):
            argv = ["--meta_path", meta, "--model_scale", "2b", "--eval_batch_size", str(BATCH),
                    "--num_segments", str(FRAMES), "--output_dir", os.path.join(d, label),
                    "--device", str(device), *extra]
            if fp32:
                argv += ["--bf16", "False"]
            for c in counters:
                c.launches = 0
            readouts.clear()
            stdout = io.StringIO()
            torch.cuda.reset_peak_memory_stats(device)
            t0 = time.perf_counter()
            with contextlib.ExitStack() as stack:
                stack.enter_context(mock.patch.object(common, "build_serving_model", opened_head))
                stack.enter_context(mock.patch.object(os, "environ", env))
                stack.enter_context(contextlib.redirect_stdout(stdout))
                if fp32:  # the kernels take bf16: the fp32 runs take the plain attention
                    stack.enter_context(mock.patch.object(fa, "flash_attention_qkv",
                                                          fa.plain_attention_qkv))
                fn(argv)
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
            counts = {c.__name__: c.launches for c in counters}
            want = {c.__name__: 0 for c in counters}
            if not fp32:
                want["flash_attention_qkv"] = batches * (n_vit + n_llm)
            want.update({k: batches * v for k, v in (launches or {}).items()})
            if counts != want:
                raise RuntimeError(f"eval {label}: launches {counts}, expected {want} "
                                   f"({batches} forwards)")
            runs[label] = dict(
                printed=stdout.getvalue(), s=wall_s,
                peak_gib=torch.cuda.max_memory_allocated(device) / 2**30,
                readout=torch.cat(readouts) if readouts else None)
            gc.collect()
            torch.cuda.empty_cache()

        def table(label, name):
            with open(os.path.join(d, label, name)) as f:
                return list(csv.reader(f))

        def metric_keys(label, name):
            with open(os.path.join(d, label, name)) as f:
                return [line.split(": ")[0] for line in f]

        def fused_line(label):
            line = [ln for ln in runs[label]["printed"].splitlines()
                    if ln.startswith("fused eval:")]
            if len(line) != 1:
                raise RuntimeError(f"{label}: no 'fused eval:' line in "
                                   f"{runs[label]['printed']!r}")
            return line[0]

        def fused_scores(label):
            """-> the p1 scores by video, after checking both perspectives'
            files."""
            fused = [table(label, f"results_p{p}.csv") for p in range(1, p_count + 1)]
            for p, t in enumerate(fused, 1):
                scores = np.asarray([float(r[3]) for r in t[1:]])
                if (t[0] != ["video_name", "answer", "mos", "pred_score"]
                        or len(scores) != n_videos or not np.isfinite(scores).all()
                        or metric_keys(label, f"metrics_p{p}.txt") != [
                            "SRCC_score", "PLCC_score", "KRCC_score"]):
                    raise RuntimeError(f"{label} perspective {p}: CSV header {t[0]}, scores "
                                       f"{scores}")
            return {r[0]: float(r[3]) for r in fused[0][1:]}

        def solo_scores(label):
            s2 = table(label, "results.csv")
            if (s2[0] != ["video_name", "answer", "output", "mos", "level", "pred_score"]
                    or len(s2) != n_videos + 1 or metric_keys(label, "metrics.txt") != [
                        "Accuracy", "SRCC", "PLCC", "KRCC", "SRCC_score", "PLCC_score",
                        "KRCC_score"]):
                raise RuntimeError(f"{label}: CSV header {s2[0]}, {len(s2) - 1} rows")
            return {r[0]: float(r[5]) for r in s2[1:]}

        def score_diff(a, b):
            """Largest difference over b's largest score."""
            if set(a) != set(b) or max(abs(v) for v in b.values()) <= 0:
                raise RuntimeError(f"eval: videos or scores {a} against {b}")
            return max(abs(a[v] - b[v]) for v in b) / max(abs(v) for v in b.values())

        def first_perspective(label):
            readout = runs[label]["readout"]
            return readout.reshape(-1, p_count, readout.shape[-1])[:, 0]

        fused_args = ("--fused_meta_paths", *metas[1:])
        run("s1", stage1_eval.main, metas[0])
        s1 = table("s1", "results.csv")
        if (s1[0] != ["video_name", "answer", "output", "mos", "level"] or len(s1) != n_videos + 1
                or metric_keys("s1", "metrics.txt") != ["Accuracy", "SRCC", "PLCC", "KRCC"]):
            raise RuntimeError(f"stage-1 eval: CSV header {s1[0]}, {len(s1) - 1} rows, metrics "
                               f"{metric_keys('s1', 'metrics.txt')}")
        run("fused", stage2_eval.main, metas[0], *fused_args)
        run("s2", stage2_eval.main, metas[0])
        run("fused_w8a8", stage2_eval.main, metas[0], *fused_args, "--eval_w8a8", "True",
            launches=dict(layernorm_quant=2 * n_vit, gelu_quant=n_vit, quant_rows=n_vit))
        run("fused_fp32", stage2_eval.main, metas[0], *fused_args, fp32=True)
        run("s2_fp32", stage2_eval.main, metas[0], fp32=True)
        fused, solo = fused_scores("fused"), solo_scores("s2")
        fused32, solo32 = fused_scores("fused_fp32"), solo_scores("s2_fp32")
        fused8 = fused_scores("fused_w8a8")

        # fp32: the wiring check
        diff32 = score_diff(fused32, solo32)
        ref = runs["s2_fp32"]["readout"]
        rel32 = relative_l2(first_perspective("fused_fp32"), ref)
        if not (diff32 <= EVAL_FP32_TOL and rel32 <= EVAL_FP32_TOL):
            raise RuntimeError(f"fp32 fused eval against the fp32 solo eval: scores {diff32}, "
                               f"readouts {rel32} (tol {EVAL_FP32_TOL})")
        # bf16: the same comparison, and each path against the fp32 readouts
        diff = score_diff(fused, solo)
        rel = relative_l2(first_perspective("fused"), runs["s2"]["readout"])
        rel_fr = relative_l2(first_perspective("fused"), ref)
        rel_sr = relative_l2(runs["s2"]["readout"], ref)
        if not (diff <= EVAL_SCORE_TOL and rel <= READOUT_TOL and rel_fr <= REF_RATIO * rel_sr):
            raise RuntimeError(
                f"fused eval against the solo stage-2 eval: scores {diff} (tol {EVAL_SCORE_TOL}), "
                f"readouts {rel} (tol {READOUT_TOL}); vs the fp32 readouts fused {rel_fr}, "
                f"solo {rel_sr} (tol {REF_RATIO}x)")
        drift = score_diff(fused8, fused)
        rel8 = relative_l2(first_perspective("fused_w8a8"), first_perspective("fused"))
        if not drift <= W8A8_EVAL_DRIFT:
            raise RuntimeError(f"--eval_w8a8 against bf16: scores {drift} (tol {W8A8_EVAL_DRIFT})")
    phase("eval", f"cli.stage1_eval.main and cli.stage2_eval.main (solo and --fused_meta_paths, "
          f"{p_count} perspectives) on a meta file of {CLI_VIDEOS} mp4 + 1 GIF, "
          f"--model_scale 2b, batch {BATCH}, {FRAMES} frames: CSV headers and {n_videos} rows "
          f"each, metrics lines as JAX writes them; {n_vit + n_llm} fused-qkv attention launches "
          f"per forward, {batches} forwards per run, W8A8 also {2 * n_vit} / {n_vit} / {n_vit} "
          f"LayerNorm / GELU / identity quantize; fused (shared prefix) against solo, "
          f"first perspective: fp32 scores {diff32:.3e} of the largest (tol {EVAL_FP32_TOL}), "
          f"readouts {rel32:.3e}; bf16 scores {diff:.3e} (tol {EVAL_SCORE_TOL}), readouts "
          f"{rel:.3e} (tol {READOUT_TOL}), vs the fp32 readouts fused {rel_fr:.3e}, solo "
          f"{rel_sr:.3e} (tol {REF_RATIO}x); bf16 scores vs fp32 fused "
          f"{score_diff(fused, fused32):.3e}, solo {score_diff(solo, solo32):.3e}; W8A8 vs bf16 "
          f"fused: scores {drift:.3e} (tol {W8A8_EVAL_DRIFT}), readouts {rel8:.3e}; largest "
          f"bf16 score {max(abs(v) for v in fused.values()):.3e}; bf16 {fused_line('fused')}; "
          f"W8A8 {fused_line('fused_w8a8')}; whole calls with the model's build (s) and peak "
          f"allocated (GiB): "
          + ", ".join(f"{k} {v['s']:.1f} / {v['peak_gib']:.2f}" for k, v in runs.items())
          + f" [{smi}]")
    return {k: v["s"] for k, v in runs.items()}


# ------------------------------------------------- the training CLIs (7c) --


def opened_score_head(model):
    """The score head ends in a ReLU: its last layer's weights made
    non-negative and its bias 0, so that random weights give scores that are
    not all 0 and follow the readout."""
    if hasattr(model, "mlpscore"):
        last = getattr(model.mlpscore, f"fc{model.mlpscore.num_layers}")
        with torch.no_grad():
            last.weight.abs_()
            last.bias.zero_()
    return model


def run_train_clis(device, smi, train_ms: float, *, n_vit: int, n_llm: int) -> dict:
    """Phase 7c: `cli/stage2_train.main` and `cli/stage1_train.main` at 2B on
    phase 10b's meta file -> launches of each attention kernel by run."""
    from aigv_assessor_torch.cli import stage1_train, stage2_train
    from aigv_assessor_torch.ops import flash_attention as fa
    from aigv_assessor_torch.utils import orbax_format

    build = stage2_train.build_training_model
    counters = training_counters(fa)
    n_videos = CLI_VIDEOS + 1
    eval_forwards = -(-n_videos // BATCH)
    layers = n_vit + n_llm
    runs = {}
    with tempfile.TemporaryDirectory() as d:
        metas = write_eval_metas(d)

        def run(label, main, batch, stage):
            out = os.path.join(d, label)
            argv = ["--meta_path", metas[0], "--model_scale", "2b", "--num_segments", str(FRAMES),
                    "--do_train", "True", "--num_train_epochs", "1",
                    "--per_device_train_batch_size", str(batch), "--evaluation_strategy",
                    "steps", "--eval_steps", "2", "--save_steps", "2",
                    "--eval_batch_size", str(BATCH), "--output_dir", out,
                    "--device", str(device)]
            if stage == 2:
                argv += ["--use_backbone_lora", str(LORA_RANK), "--use_llm_lora", str(LORA_RANK)]
            for c in counters:
                c.launches = 0
            torch.cuda.reset_peak_memory_stats(device)
            t0 = time.perf_counter()
            with mock.patch.object(stage2_train, "build_training_model",
                                   lambda *a, **kw: opened_score_head(build(*a, **kw))):
                trainer = main(argv)
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
            counts = {c.__name__: c.launches for c in counters}
            peak = torch.cuda.max_memory_allocated(device) / 2**30
            steps = n_videos // batch
            evals = steps // 2
            with open(os.path.join(out, "train_log.jsonl")) as f:
                log = [json.loads(line) for line in f]
            losses = [r["loss"] for r in log if "loss" in r]
            times = {r["step"]: r["time"] for r in log if "loss" in r}
            if (len(losses) != steps or not np.isfinite(losses).all() or trainer.step != steps
                    or sorted(times) != list(range(1, steps + 1))):
                raise RuntimeError(f"{label}: losses {losses} after {trainer.step} steps, "
                                   f"expected {steps}")
            # steps 1 -> 2 and 3 -> 4 hold no eval or checkpoint between them
            step_ms = [(times[s + 1] - times[s]) * 1e3 for s in range(1, steps, 2)]
            per_mb = {"flash_attention_qkv_lse": 2 * layers if stage == 2 else 2 * n_llm,
                      "flash_attention_qkv_bwd_kernel": layers if stage == 2 else n_llm}
            want = {c.__name__: 0 for c in counters}
            want.update({k: steps * v for k, v in per_mb.items()})
            # the frozen ViT of stage 1 runs forward only; each eval forward
            # runs both towers without logsumexp
            want["flash_attention_qkv"] = (evals * eval_forwards * layers
                                           + (steps * n_vit if stage == 1 else 0))
            if counts != want:
                raise RuntimeError(f"{label}: launches {counts}, expected {want} ({steps} "
                                   f"micro-batches, {evals * eval_forwards} eval forwards)")
            with open(os.path.join(out, "results.csv")) as f:
                table = list(csv.reader(f))
            header = ["video_name", "answer", "output", "mos", "level"]
            keys = ["Accuracy", "SRCC", "PLCC", "KRCC"]
            if stage == 2:
                header.append("pred_score")
                keys += ["SRCC_score", "PLCC_score", "KRCC_score"]
            with open(os.path.join(out, "metrics.txt")) as f:
                metrics = [line.rstrip("\n").split(": ") for line in f]
            if (table[0] != header or len(table) != n_videos + 1
                    or [k for k, _ in metrics] != keys * evals):
                raise RuntimeError(f"{label}: CSV header {table[0]}, {len(table) - 1} rows, "
                                   f"metrics {[k for k, _ in metrics]}")
            if stage == 2:
                scores = np.asarray([float(r[5]) for r in table[1:]])
                if not np.isfinite(scores).all() or not np.abs(scores).max() > 0:
                    raise RuntimeError(f"{label}: pred_score {scores}")
            artifact = (stage2_train.LORA_FILE if stage == 2 else stage1_train.TRAINABLE_FILE)
            for path in ("checkpoints/best/state/_METADATA",
                         f"checkpoints/{steps}/default/_METADATA", artifact):
                if not os.path.exists(os.path.join(out, path)):
                    raise RuntimeError(f"{label}: no {path}")
            runs[label] = dict(counts=counts, steps=steps, batch=batch, wall_s=wall_s,
                               peak_gib=peak, step_ms=step_ms, losses=losses,
                               metrics=metrics[-len(keys):],
                               best_step=int(orbax_format.read_tree(
                                   os.path.join(out, "checkpoints/best/state"),
                                   names=["step"])[0][1]))
            del trainer
            gc.collect()
            torch.cuda.empty_cache()

        run("stage2", stage2_train.main, 2, 2)
        run("stage1", stage1_train.main, 4, 1)
    for label, r in runs.items():
        per_mb = {k: v // r["steps"] for k, v in r["counts"].items()
                  if v and k != "flash_attention_qkv"}
        lora = f" LoRA r={LORA_RANK} both towers" if label == "stage2" else ""
        mean_ms = float(np.mean(r["step_ms"]))
        phase("train-cli", f"cli.{label}_train.main --model_scale 2b{lora} on phase 10b's "
              f"meta ({CLI_VIDEOS} mp4 + 1 GIF, {FRAMES} frames, bf16), batch {r['batch']}, "
              f"1 epoch = {r['steps']} steps, an eval (batch {BATCH}) and a checkpoint every 2: "
              f"losses {np.round(r['losses'], 5).tolist()}; {mean_ms:.1f} ms/step "
              f"({np.round(r['step_ms'], 1).tolist()}), {mean_ms / r['batch']:.1f} ms per "
              f"video (train_steps, phase 7: {train_ms:.1f} ms/step of {BATCH} videos, "
              f"{train_ms / BATCH:.1f} per video); peak {r['peak_gib']:.2f} GiB allocated; "
              f"whole call {r['wall_s']:.1f} s with the model's build; launches per "
              f"micro-batch {per_mb}, {r['counts']['flash_attention_qkv']} forward-only K1 in "
              f"all (the evals{' and the frozen ViT' if label == 'stage1' else ''}); best "
              f"checkpoint at step {r['best_step']}; last eval "
              f"{ {k: round(float(v), 4) for k, v in r['metrics']} } [{smi}]")
    return runs


# ------------------------------------------------------ HTTP serving (12) --


def http_call(address, method, path, body=None, ctype=None):
    import http.client

    conn = http.client.HTTPConnection(*address, timeout=600)
    try:
        conn.request(method, path, body=body, headers={"Content-Type": ctype} if ctype else {})
        r = conn.getresponse()
        return r.status, json.loads(r.read())
    finally:
        conn.close()


def run_serve(device, smi, *, n_vit: int, n_llm: int) -> dict:
    """Phase 12: `cli/serve.ScoringService` behind `_Server` on 127.0.0.1 at
    2B, bf16 then W8A8 -> launches of each kernel by precision."""
    import threading

    from aigv_assessor_torch.cli import common, score, serve
    from aigv_assessor_torch.ops import decode_attention as dec
    from aigv_assessor_torch.ops import flash_attention as fa
    from aigv_assessor_torch.ops import quant_fuse as qf
    from aigv_assessor_torch.ops.preprocess import resize_normalize

    build = common.build_serving_model
    counters = (fa.flash_attention_qkv, fa.flash_attention, fa.flash_attention_qkv_lse,
                dec.decode_attention, dec.cached_decode_attention, qf.layernorm_quant,
                qf.gelu_quant, qf.quant_rows, qf.rmsnorm_quant, qf.silu_mul_quant)
    # the W8A8 feeds at JAX's default (`AIGV_FUSE_QUANT` unset: the ViT's)
    env = {k: v for k, v in os.environ.items() if not k.startswith("AIGV_")}
    questions = list(EVAL_PERSPECTIVES)
    layers = n_vit + n_llm
    runs = {}
    with tempfile.TemporaryDirectory() as d:
        write_cli_videos(d)
        paths = score.list_videos(d)
        bodies = {p: open(p, "rb").read() for p in paths}

        def post(address, p):
            status, body = http_call(address, "POST", "/score", bodies[p],
                                     "image/gif" if p.endswith(".gif") else "video/mp4")
            if status != 200:
                raise RuntimeError(f"serve: POST {os.path.basename(p)} -> {status} {body}")
            return np.asarray([body["scores"][q] for q in questions], np.float64)

        for label, w8a8 in (("bf16", False), ("w8a8", True)):
            t0 = time.perf_counter()
            with mock.patch.object(common, "build_serving_model",
                                   lambda *a, **kw: opened_score_head(build(*a, **kw))), \
                    mock.patch.object(os, "environ", env):
                svc = serve.ScoringService(questions, model_scale="2b", batch_size=BATCH,
                                           num_segments=FRAMES, w8a8=w8a8, device=device)
            svc.warmup()  # the kernels are built by now; the batch shape is fixed
            torch.cuda.synchronize()
            init_s = time.perf_counter() - t0
            server = serve._Server(("127.0.0.1", 0), serve.make_handler(svc))
            thread = threading.Thread(target=server.serve_forever, daemon=True)
            thread.start()
            address = server.server_address
            try:
                status, health = http_call(address, "GET", "/healthz")
                if status != 200 or health.get("status") != "ok":
                    raise RuntimeError(f"serve: /healthz {status} {health}")
                for c in counters:
                    c.launches = 0
                batches0 = svc.stats.batches
                torch.cuda.reset_peak_memory_stats(device)
                solo = {p: post(address, p) for p in paths}  # one at a time
                n_requests, n_clients = 32, 8
                order = [paths[i % len(paths)] for i in range(n_requests)]
                grouped, latency = [None] * n_requests, [None] * n_requests

                def client(k):
                    for i in range(k, n_requests, n_clients):
                        t = time.perf_counter()
                        grouped[i] = post(address, order[i])
                        latency[i] = time.perf_counter() - t

                clients = [threading.Thread(target=client, args=(k,)) for k in range(n_clients)]
                t0 = time.perf_counter()
                for t in clients:
                    t.start()
                for t in clients:
                    t.join(timeout=600)
                wall_s = time.perf_counter() - t0
                torch.cuda.synchronize()
                counts = {c.__name__: c.launches for c in counters}
                batches = svc.stats.batches - batches0
                peak = torch.cuda.max_memory_allocated(device) / 2**30
                status, statz = http_call(address, "GET", "/statz")
            finally:
                server.shutdown()
                server.server_close()
            if any(t.is_alive() for t in clients) or any(g is None for g in grouped):
                raise RuntimeError("serve: a client never got its reply")
            # the reference: the same uint8 frames, in batches of four videos,
            # through model.score_perspectives on the service's prompts
            # (the main thread alone: each batch's host time to return and its
            # device time by CUDA events, beside the worker's assemble time)
            frames = [svc.decode(p) for p in paths]
            ref, host_ms, device_ms = {}, [], []
            with torch.inference_mode():
                for i in range(0, len(paths), BATCH):
                    chunk = frames[i : i + BATCH]
                    chunk += [chunk[-1]] * (BATCH - len(chunk))
                    px = torch.as_tensor(np.stack(chunk), device=device)
                    torch.cuda.synchronize()
                    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                    t = time.perf_counter()
                    start.record()
                    pv = resize_normalize(px, size=px.shape[-2],
                                          dtype=svc.model.precision.compute_dtype)
                    s = svc.model.score_perspectives(
                        svc._ids, pv, svc._mask, shared_prefix_len=svc.prefix_len or None)
                    end.record()
                    host_ms.append((time.perf_counter() - t) * 1e3)
                    end.synchronize()
                    device_ms.append(start.elapsed_time(end))
                    for p, row in zip(paths[i : i + BATCH], s.float().cpu().numpy()):
                        ref[p] = row.astype(np.float64) * svc.mos_scale
                # the host syncs of one batch, counted by PyTorch's sync
                # debug mode (outside the timed calls): host time = device
                # time means either these or launches as slow as the card
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    with warnings.catch_warnings(record=True) as caught:
                        warnings.simplefilter("always")
                        svc.model.score_perspectives(svc._ids, pv, svc._mask,
                                                     shared_prefix_len=svc.prefix_len or None)
                finally:
                    torch.cuda.set_sync_debug_mode(0)
                syncs = [str(w.message).splitlines()[0] for w in caught
                         if "synchroniz" in str(w.message)]
            prefix_len, decoder = svc.prefix_len, svc.decoder
            svc.close()
            del svc
            gc.collect()
            torch.cuda.empty_cache()

            def rel_diff(a, b):
                """Largest difference over b's largest score."""
                top = max(float(np.abs(v).max()) for v in b)
                if not top > 0:
                    raise RuntimeError(f"serve {label}: every score is 0")
                return max(float(np.abs(x - y).max()) for x, y in zip(a, b)) / top

            if not all(np.isfinite(v).all() for v in solo.values()):
                raise RuntimeError(f"serve {label}: scores {solo}")
            vs_ref = rel_diff([solo[p] for p in paths], [ref[p] for p in paths])
            vs_solo = rel_diff(grouped, [solo[p] for p in order])
            if not (vs_ref <= SCORE_TOL and vs_solo <= SCORE_TOL):
                raise RuntimeError(f"serve {label}: replies against score_perspectives "
                                   f"{vs_ref}, grouped against solo {vs_solo} (tol {SCORE_TOL})")
            want = {c.__name__: 0 for c in counters}
            want["flash_attention_qkv"] = batches * layers  # the ViT and the shared prefix
            if w8a8:
                want.update(layernorm_quant=batches * 2 * n_vit, gelu_quant=batches * n_vit,
                            quant_rows=batches * n_vit)
            if counts != want or prefix_len <= 0:
                raise RuntimeError(f"serve {label}: launches {counts} over {batches} batches, "
                                   f"expected {want}; shared prefix {prefix_len}")
            lat = np.asarray(latency) * 1e3
            runs[label] = dict(counts=counts, batches=batches, solo=solo, init_s=init_s,
                               videos_per_s=n_requests / wall_s,
                               p50_ms=float(np.percentile(lat, 50)),
                               p99_ms=float(np.percentile(lat, 99)), statz=statz, peak_gib=peak,
                               vs_ref=vs_ref, vs_solo=vs_solo, prefix_len=prefix_len,
                               host_ms=host_ms, device_ms=device_ms, syncs=syncs)
            if label == "bf16":
                # the offline CLI on the same files, questions, batch and frames
                stdout = io.StringIO()
                with mock.patch.object(os, "environ", env), contextlib.redirect_stdout(stdout):
                    score.main(["--videos", d, "--model_scale", "2b", "--batch_size", str(BATCH),
                                "--num_segments", str(FRAMES), "--device", str(device),
                                "--out", os.path.join(d, "scores.csv"),
                                *[a for q in questions for a in ("--question", q)]])
                torch.cuda.synchronize()
                runs[label]["offline"] = json.loads(stdout.getvalue().strip().splitlines()[-1])
                gc.collect()
                torch.cuda.empty_cache()
    drift = max(float(np.abs(runs["w8a8"]["solo"][p] - runs["bf16"]["solo"][p]).max())
                for p in paths) / max(float(np.abs(v).max()) for v in runs["bf16"]["solo"].values())
    if not drift <= W8A8_EVAL_DRIFT:
        raise RuntimeError(f"serve: W8A8 against bf16 scores {drift} (tol {W8A8_EVAL_DRIFT})")
    offline = runs["bf16"]["offline"]
    for label, r in runs.items():
        per_batch = {k: v // r["batches"] for k, v in r["counts"].items() if v}
        phase("serve", f"cli.serve ScoringService + _Server on 127.0.0.1, --model_scale 2b "
              f"{label}, seed 0, {len(questions)} questions on a shared prefix of "
              f"{r['prefix_len']} tokens, batch {BATCH}, {FRAMES} frames, decoder {decoder}: "
              f"{len(paths)} videos ({CLI_VIDEOS} mp4 + 1 GIF) POSTed one at a time, then 32 "
              f"requests from 8 client threads: {r['videos_per_s']:.2f} videos/s online, "
              f"latency p50 {r['p50_ms']:.1f} ms, p99 {r['p99_ms']:.1f} ms (offline cli.score "
              f"bf16 on the same {len(paths)} files: {offline['value']} videos/s, decode "
              f"included); replies vs model.score_perspectives on the same uint8 frames "
              f"{r['vs_ref']:.3e}, grouped vs solo {r['vs_solo']:.3e} of the largest score (tol "
              f"{SCORE_TOL}); launches per batch {per_batch} over {r['batches']} batches, K8 0; "
              f"/statz {json.dumps(r['statz'])}; a batch from the main thread alone: host "
              f"{np.round(r['host_ms'], 1).tolist()} ms to return, device "
              f"{np.round(r['device_ms'], 1).tolist()} ms, {len(r['syncs'])} host syncs "
              f"{sorted(set(r['syncs']))[:3]}; peak {r['peak_gib']:.2f} GiB "
              f"allocated, build "
              f"and warm-up {r['init_s']:.1f} s"
              + (f"; W8A8 vs bf16 scores {drift:.3e} (tol {W8A8_EVAL_DRIFT})"
                 if label == "w8a8" else "") + f" [{smi}]")
    return runs


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
        if layout == "bshd":
            q, k, v = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    dout = torch.randn(q.shape, generator=gen, device=device)
    if name.startswith("vit"):
        dout[:, kv_valid:] = 0.0
    return q, k, v, dout.to(torch.bfloat16)


def separate_work(shape) -> dict:
    """FLOPs and bytes of the attention kernels at one shape, from what this
    run's masks leave: Sq * kv_valid (query, key) pairs, or the causal
    triangle. Products per pair and head dim element: forward 2 (QK^T, PV),
    the backward 5 (QK^T, dO V^T, P^T dO, dS^T Q, dS K: what any backward
    runs) plus delta's multiply-add per element of out. Bytes: each input
    read once, each output written once (dQ's fp32 running sums are the
    kernel's own workspace, not counted). "delta" is rowsum(dout * out)
    alone, the backward's first launch."""
    b, sq, skv, hq, hkv, d, causal, kv_valid, _ = shape
    pairs = sq * (sq + 1) // 2 if causal else sq * (kv_valid or skv)
    per_product = 2 * b * hq * pairs * d
    q_bytes, kv_bytes, stat = b * hq * sq * d * 2, b * hkv * skv * d * 2, b * hq * sq * 4
    qkv = q_bytes + 2 * kv_bytes
    delta = (2 * b * hq * sq * d, 2 * q_bytes + stat)  # rowsum(dout * out): reads both
    return {
        "fwd": (2 * per_product, qkv + q_bytes),
        "fwd_lse": (2 * per_product, qkv + q_bytes + stat),
        # reads q, k, v, out, dout and lse, writes delta, dq, dk and dv
        "bwd": (5 * per_product + delta[0], qkv + 3 * q_bytes + 2 * stat + 2 * kv_bytes),
        "delta": delta,
    }


def check_attention_separate_training(fa, device, shapes) -> dict:
    """K2's forward with logsumexp and its backward kernel against the plain
    versions, timed by CUDA graph replay, beside the bound, the plain versions
    and SDPA."""
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
        one_key = min(skv, kv_valid or skv) == 1
        bwd_text = (f"rel L2 dq {rel['dq']:.3e} dk {rel['dk']:.3e} dv {rel['dv']:.3e} (tol "
                    f"{BWD_TOL})")
        if one_key:  # as in check_attention_training: dq and dk are 0 there
            zero = max(dq.abs().max().item(), dk.abs().max().item())
            if zero > ZERO_GRAD_ATOL:
                raise RuntimeError(f"K2 {name}: dq / dk above {ZERO_GRAD_ATOL} where they are 0")
            bwd_text = (f"one valid key per row: max |dq|, |dk| {zero:.3e} (tol "
                        f"{ZERO_GRAD_ATOL}), rel L2 dv {rel['dv']:.3e} (tol {BWD_TOL})")
        if not all(rel[n] <= BWD_TOL for n in (("dv",) if one_key else rel)):
            raise RuntimeError(f"K2 {name}: backward relative L2 {rel} above {BWD_TOL}")
        seq = 2 if layout == "bhsd" else 1
        if kv_valid is not None and (dk.narrow(seq, kv_valid, skv - kv_valid).any()
                                     or dv.narrow(seq, kv_valid, skv - kv_valid).any()):
            raise RuntimeError(f"K2 {name}: dk/dv rows of masked keys are not exactly 0")
        del want, plain_lse

        # the entry into given buffers: delta from its first launch, a second
        # run bit-equal
        delta = torch.empty_like(lse)
        again = [torch.empty_like(t) for t in (dq, dk, dv)]
        bwd_args = (q, k, v, out, dout, lse, delta, *again)
        fa.flash_attention_bwd_kernel(*bwd_args, **kw)
        torch.cuda.synchronize()
        want_delta = (dout.float() * out.float()).sum(-1)
        delta_rel = relative_l2(delta, want_delta if layout == "bhsd" else
                                want_delta.transpose(1, 2))
        if delta_rel > DELTA_TOL:
            raise RuntimeError(f"K2 {name}: delta relative L2 {delta_rel} above {DELTA_TOL}")
        if not all(torch.equal(x, y) for x, y in zip(again, (dq, dk, dv))):
            raise RuntimeError(f"K2 {name}: a second run of the backward differs")
        ms_lse = graph_ms([lambda: fa.flash_attention_lse(q, k, v, **kw)] * 3, 5)
        ms_bwd = graph_ms([lambda: fa.flash_attention_bwd_kernel(*bwd_args, **kw)] * 3, 5)
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
            library_ms = graph_ms([lambda: sdpa(qs, ks, vs, lib_shape)] * 3, 10)
        qg, kg, vg = (t.detach().requires_grad_() for t in (qs, ks, vs))

        def fwd_bwd():
            torch.autograd.grad(sdpa(qg, kg, vg, lib_shape), (qg, kg, vg), dos)

        library_fwd_bwd_ms = time_ms(fwd_bwd, 10)
        lib_out = sdpa(qg, kg, vg, lib_shape)  # the backward alone, on a kept forward
        library_bwd_ms = time_ms(
            lambda: torch.autograd.grad(lib_out, (qg, kg, vg), dos, retain_graph=True), 10)
        del lib_out
        work = separate_work(shape)
        bounds = {n: bound_ms(*work[n]) for n in ("fwd_lse", "bwd", "delta")}
        text = (f"{layout} B={b} Sq={sq} Skv={skv} hq={hq} hkv={hkv} D={d} causal={causal} "
                f"kv_valid={kv_valid}")
        results[name] = dict(
            shape=text, lse_max_abs_err=lse_err, rel_l2=rel, max_abs_err=err,
            lse_ms=ms_lse, **{f"lse_{k}": v for k, v in
                              rate(work["fwd_lse"][0], bounds["fwd_lse"][0], ms_lse).items()},
            library_tflops=rate(work["fwd_lse"][0], bounds["fwd_lse"][0], library_ms)["tflops"],
            bwd_ms=ms_bwd, plain_lse_ms=plain_lse_ms, delta_rel_l2=delta_rel,
            **{f"bwd_{n}": v for n, v in rate(work["bwd"][0], bounds["bwd"][0], ms_bwd).items()},
            plain_bwd_ms=plain_bwd_ms, library_ms=library_ms,
            library_bwd_ms=library_bwd_ms, library_fwd_bwd_ms=library_fwd_bwd_ms,
            bounds={n: dict(bound_ms=v[0], bound_by=v[1]) for n, v in bounds.items()})
        phase("kernel", f"K2 training {name}: {text}: out bit-equal with and without lse, lse "
              f"max_abs_err {lse_err:.3e} (tol {LSE_TOL}); {bwd_text}, masked-key rows exactly 0, "
              f"delta rel L2 {delta_rel:.3e} (tol {DELTA_TOL}), second run bit-equal; "
              f"by graph replay fwd+lse {ms_lse:.4f} ms "
              f"({rate_text(work['fwd_lse'][0], bounds['fwd_lse'][0], ms_lse)}; bound "
              f"{bounds['fwd_lse'][0]:.4f}, plain {plain_lse_ms:.4f}, SDPA fwd {library_ms:.4f} "
              f"({rate_text(work['fwd_lse'][0], bounds['fwd_lse'][0], library_ms)})), backward "
              f"{ms_bwd:.4f} ms ({rate_text(work['bwd'][0], bounds['bwd'][0], ms_bwd)}; bound "
              f"{bounds['bwd'][0]:.4f}), plain backward {plain_bwd_ms:.4f} ms, SDPA backward "
              f"{library_bwd_ms:.4f} ms, SDPA fwd+bwd {library_fwd_bwd_ms:.4f} ms")
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
                "flash_attention_qkv_bwd_kernel": n_llm}
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
    return (fa.flash_attention_qkv, fa.flash_attention_qkv_lse, fa.flash_attention_qkv_bwd_kernel,
            fa.flash_attention, fa.flash_attention_lse, fa.flash_attention_bwd_kernel)


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
    # forward + recompute, one backward: K1 lse, K3 and K2 lse, K2's backward
    want_launches = [0, 2 * DEPTH_CUT, DEPTH_CUT, 0, 2 * DEPTH_CUT, DEPTH_CUT]
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
               cut_grads=dict(kernel_plain=gk, kernel_fp32=gr, plain_fp32=gp),
               cut_readout_bf16=k_)
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
    per_step = {"flash_attention_lse": 2 * n_vit, "flash_attention_bwd_kernel": n_vit,
                "flash_attention_qkv_lse": 2 * n_llm, "flash_attention_qkv_bwd_kernel": n_llm}
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


# ---------------------- LoRA over quantized bases, 26B quantized, the ViT (13) --

# lora_b of phase 13a-c's adapters, drawn from N(0, LORA_B_STD) instead of
# zero, so that live and merged adapters compute other functions
LORA_B_STD = 0.02
LORA_GEN_TOKENS = 8  # phase 13c
REMAT_POLICY = "dots_with_no_batch_dims_saveable"  # phase 13e
VIT_SIZE = 336  # phase 13f: 24 x 24 patches against the 32 x 32 position embedding


def state_gib(model) -> float:
    """GiB of a model's parameters and buffers."""
    return sum(t.numel() * t.element_size() for t in model.state_dict().values()) / 2**30


def lora_reference(cfg, device):
    """The 2B model in fp32, seed 0, with rank-LORA_RANK adapters live in
    both towers, lora_b drawn non-zero and the score head opened -> (model,
    its config). Its state_dict is phase 13a-c's LoRA checkpoint."""
    from aigv_assessor_torch.cli.score import build_serving_model
    from aigv_assessor_torch.core.precision import Precision

    lcfg = cfg.replace(use_backbone_lora=LORA_RANK, use_llm_lora=LORA_RANK)
    model = build_serving_model(lcfg, device=device, precision=Precision.fp32(), seed=0)
    gen = torch.Generator(device=device).manual_seed(9)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("lora_b"):
                p.normal_(0.0, LORA_B_STD, generator=gen)
    return opened_score_head(model), lcfg


def merged_checkpoint(ref, lcfg, device):
    """The LoRA checkpoint with its adapters folded into the fp32 bases by
    `models/lora.merge_lora_` -> (the config without adapters, its
    weights): the control that quantizes W + delta, as the port's builds
    did before adapters ran live over a quantized base."""
    from aigv_assessor_torch.cli.score import build_serving_model
    from aigv_assessor_torch.core.precision import Precision
    from aigv_assessor_torch.models.lora import lora_free_state_dict, merge_lora_

    model = build_serving_model(lcfg, device=device, precision=Precision.fp32(), seed=0,
                                weights=ref.state_dict())
    return (lcfg.replace(use_backbone_lora=0, use_llm_lora=0),
            lora_free_state_dict(merge_lora_(model)))


def run_lora_quantized(ref, lcfg, merged, device, ids, mask, px_u8, chunk, ids_pn, mask_pn,
                       smi, *, n_vit: int, n_llm: int, base_ms: dict) -> dict:
    """Phase 13a: the LoRA checkpoint served with its adapters live over a
    W8A8, int8 and int4 base -> per mode its launches, ms per chunk and peak
    GiB. merged: `merged_checkpoint`. base_ms: each mode's ms per chunk
    without adapters (phases 5, 6)."""
    from aigv_assessor_torch.cli.score import build_serving_model, score_batch, score_chunks
    from aigv_assessor_torch.models.lora import AdaptedLinear, QuantizedLinear
    from aigv_assessor_torch.ops import flash_attention as fa
    from aigv_assessor_torch.ops import int8_matmul as wo
    from aigv_assessor_torch.ops import quant_fuse as qf
    from aigv_assessor_torch.ops.preprocess import resize_normalize

    weights = ref.state_dict()
    counters = (fa.flash_attention_qkv, fa.flash_attention, wo.int8_matmul, wo.int4_matmul,
                qf.layernorm_quant, qf.gelu_quant, qf.quant_rows, qf.rmsnorm_quant,
                qf.silu_mul_quant)
    swaps = ((fa, "flash_attention_qkv", fa.plain_attention_qkv),
             (fa, "flash_attention", fa.plain_flash_attention),
             (wo, "int8_matmul", wo.plain_int8_matmul), (wo, "int4_matmul", wo.plain_int4_matmul))
    with torch.inference_mode():
        pv = resize_normalize(px_u8, size=IMAGE, dtype=torch.float32)
        with plain_attention_patches(fa):  # the kernels take bf16
            r = ref(ids[:, 0], pv, mask[:, 0])["readout"].float()
    out = {}
    for mode in ("w8a8", "int8", "int4"):
        t0 = time.perf_counter()
        model = build_serving_model(lcfg, device=device, seed=0, weights=weights,
                                    **{mode: True})
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        weights_gib = state_gib(model)
        adapted = [m for m in model.modules() if isinstance(m, AdaptedLinear) and m.lora]
        quantized = [m for m in adapted if isinstance(m, QuantizedLinear)]
        n_quantized = (4 * n_vit if mode == "w8a8" else 0) + 5 * n_llm
        if len(adapted) != 4 * n_vit + 5 * n_llm or len(quantized) != n_quantized:
            raise RuntimeError(f"LoRA {mode}: {len(adapted)} adapted projections, "
                               f"{len(quantized)} of them quantized")
        score_batch(model, ids, px_u8, mask)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        held = torch.cuda.memory_allocated(device)
        for c in counters:
            c.launches = 0
        for c in (wo.int8_matmul, wo.int4_matmul):
            c.form_launches = dict.fromkeys(wo.FORMS, 0)
        t0 = time.perf_counter()
        rows = score_chunks(model, [chunk], ids_pn, mask_pn, batch_size=BATCH)
        torch.cuda.synchronize()
        chunk_ms = (time.perf_counter() - t0) * 1e3
        # the model and what the chunk allocated on top of all that was held
        peak = weights_gib + (torch.cuda.max_memory_allocated(device) - held) / 2**30
        counts = {c.__name__: c.launches for c in counters}
        want = dict.fromkeys(counts, 0)
        matmul = f"{mode}_matmul"
        if mode == "w8a8":  # K1 `bsd` in both towers; every feed off under adapters
            want["flash_attention_qkv"] = n_vit + n_llm
        else:
            want.update(flash_attention_qkv=n_vit, flash_attention=n_llm, **{matmul: 5 * n_llm})
            forms = dict(getattr(wo, matmul).form_launches)
            if forms != dict(dict.fromkeys(wo.FORMS, 0), gemm=5 * n_llm):
                raise RuntimeError(f"LoRA {mode}: matmul forms {forms}")
        if counts != want or not np.isfinite(np.asarray(rows)).all():
            raise RuntimeError(f"LoRA {mode}: launches {counts}, expected {want}; rows {rows}")
        with torch.inference_mode():
            x = pv.to(torch.bfloat16)
            k = model(ids[:, 0], x, mask[:, 0])["readout"].float()
            with contextlib.ExitStack() as stack:
                for module, name, plain in swaps:
                    stack.enter_context(mock.patch.object(module, name, plain))
                p_ = model(ids[:, 0], x, mask[:, 0])["readout"].float()
            del model
            control = build_serving_model(merged[0], device=device, seed=0, weights=merged[1],
                                          **{mode: True})
            m_ = control(ids[:, 0], x, mask[:, 0])["readout"].float()
            del control
        tol = W8A8_READOUT_TOL if mode == "w8a8" else WEIGHT_ONLY_READOUT_TOL
        rel_kp, rel_kr, rel_pr, rel_mr, rel_km = (
            relative_l2(k, p_), relative_l2(k, r), relative_l2(p_, r), relative_l2(m_, r),
            relative_l2(k, m_))
        if not torch.isfinite(k).all() or not rel_kp <= tol or not rel_kr <= REF_RATIO * rel_pr:
            raise RuntimeError(f"LoRA {mode}: readout kernel vs plain {rel_kp} (tol {tol}); vs "
                               f"the fp32 live forward kernel {rel_kr}, plain {rel_pr} (tol "
                               f"{REF_RATIO}x)")
        phase("lora", f"13a {mode} base, r={LORA_RANK} adapters live in both towers (lora_b "
              f"~N(0, {LORA_B_STD})), InternVL2-2B: launches per forward "
              f"{ {k_: v for k_, v in counts.items() if v} }, {chunk_ms:.1f} ms/chunk "
              f"(without adapters {base_ms[mode]:.1f}), peak {peak:.2f} GiB allocated "
              f"(weights {weights_gib:.2f} GiB), init {init_s:.1f} s; readout rel L2 kernel vs "
              f"plain {rel_kp:.3e} (tol {tol}); to the fp32 live-adapter forward: live kernel "
              f"{rel_kr:.3e}, plain {rel_pr:.3e} (tol {REF_RATIO}x), merged-then-quantized "
              f"{rel_mr:.3e}; live vs merged {rel_km:.3e} [{smi}]")
        out[mode] = dict(counts=counts, ms=chunk_ms, peak_gib=peak, weights_gib=weights_gib,
                         live_fp32=rel_kr, merged_fp32=rel_mr)
        gc.collect()
        torch.cuda.empty_cache()
    return out


def run_lora_eval(ref, merged, device, smi, *, n_vit: int, n_llm: int, eval_s: dict) -> dict:
    """Phase 13b: `cli.stage2_eval.main --eval_w8a8 True` on phase 10b's
    meta files with the LoRA checkpoint (through `cli/common.model_weights`),
    solo (which, as JAX's, takes no W8A8) and fused (W8A8 over live
    adapters); and fused on the control (`merged_checkpoint`, without
    adapters). The fused runs' `score_batch` calls are recorded and replayed
    on the live model built outside the CLI from the config the CLI built
    (its kernels, then the plain attention). eval_s: phase 10b's wall
    times."""
    from aigv_assessor_torch.cli import common, score, stage2_eval
    from aigv_assessor_torch.ops import decode_attention as dec
    from aigv_assessor_torch.ops import flash_attention as fa
    from aigv_assessor_torch.ops import quant_fuse as qf

    weights = ref.state_dict()
    build, score_batch = common.build_serving_model, score.score_batch
    counters = (fa.flash_attention_qkv, fa.flash_attention, dec.cached_decode_attention,
                qf.layernorm_quant, qf.gelu_quant, qf.quant_rows, qf.rmsnorm_quant,
                qf.silu_mul_quant)
    env = {k: v for k, v in os.environ.items() if not k.startswith("AIGV_")}
    n_videos = CLI_VIDEOS + 1
    batches = -(-n_videos // BATCH)
    runs = {}
    with tempfile.TemporaryDirectory() as d:
        metas = write_eval_metas(d)
        base = ["--meta_path", metas[0], "--model_scale", "2b", "--eval_batch_size", str(BATCH),
                "--num_segments", str(FRAMES), "--device", str(device), "--eval_w8a8", "True"]
        lora = ["--use_backbone_lora", str(LORA_RANK), "--use_llm_lora", str(LORA_RANK)]
        fused = ["--fused_meta_paths", *metas[1:]]
        for label, extra, ckpt in (("solo", lora, weights), ("fused", lora + fused, weights),
                                   ("fused_merged", fused, merged[1])):
            calls, configs = [], []

            def recorded_build(config, **kw):
                configs.append(config)
                return build(config, **kw)

            def recorded_score(model, *args):
                out = score_batch(model, *args)
                calls.append((args, out.float()))
                return out

            for c in counters:
                c.launches = 0
            torch.cuda.reset_peak_memory_stats(device)
            stdout = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.ExitStack() as stack:
                stack.enter_context(mock.patch.object(common, "model_weights",
                                                      lambda args, config, w=ckpt: w))
                stack.enter_context(mock.patch.object(common, "build_serving_model",
                                                      recorded_build))
                stack.enter_context(mock.patch.object(score, "score_batch", recorded_score))
                stack.enter_context(mock.patch.object(os, "environ", env))
                stack.enter_context(contextlib.redirect_stdout(stdout))
                stage2_eval.main(base + ["--output_dir", os.path.join(d, label)] + extra)
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
            counts = {c.__name__: c.launches for c in counters}
            want = dict.fromkeys(counts, 0)
            want["flash_attention_qkv"] = batches * (n_vit + n_llm)
            if label == "fused_merged":  # no adapter: the ViT's feeds fused, as in phase 10b
                want.update(layernorm_quant=batches * 2 * n_vit, gelu_quant=batches * n_vit,
                            quant_rows=batches * n_vit)
            if counts != want:
                raise RuntimeError(f"LoRA eval {label}: launches {counts}, expected {want}")
            name = "results_p1.csv" if fused[0] in extra else "results.csv"
            with open(os.path.join(d, label, name)) as f:
                table = list(csv.reader(f))
            col = 3 if fused[0] in extra else 5
            scores = {r[0]: float(r[col]) for r in table[1:]}
            if len(scores) != n_videos or not np.isfinite(list(scores.values())).all():
                raise RuntimeError(f"LoRA eval {label}: scores {scores}")
            runs[label] = dict(s=wall_s, scores=scores, printed=stdout.getvalue(),
                               peak_gib=torch.cuda.max_memory_allocated(device) / 2**30,
                               calls=calls, config=configs[0])
            gc.collect()
            torch.cuda.empty_cache()

    def score_diff(a, b):
        return max(abs(a[v] - b[v]) for v in b) / max(abs(v) for v in b.values())

    # the live model outside the CLI, on the fused runs' recorded batches
    live_cfg, control = runs["fused"]["config"], runs["fused_merged"]
    if (live_cfg.use_backbone_lora, live_cfg.use_llm_lora) != (LORA_RANK, LORA_RANK):
        raise RuntimeError(f"LoRA eval: the CLI built {live_cfg}")
    calls = runs["fused"]["calls"]
    if len(calls) != batches or len(control["calls"]) != batches or not all(
            torch.equal(a, b) if torch.is_tensor(a) else a == b
            for (x, _), (y, _) in zip(calls, control["calls"]) for a, b in zip(x, y)):
        raise RuntimeError("LoRA eval: the fused runs scored other batches")
    model = build(live_cfg, device=device, seed=0, weights=weights, w8a8=True)
    with torch.inference_mode():
        replay = torch.cat([score_batch(model, *args).float() for args, _ in calls])
        with mock.patch.object(fa, "flash_attention_qkv", fa.plain_attention_qkv):
            plain = torch.cat([score_batch(model, *args).float() for args, _ in calls])
        cli = torch.cat([out for _, out in calls])
        merged_out = torch.cat([out for _, out in control["calls"]])
        largest = float(replay.abs().max())
        d_live, d_merged, d_plain = (float((x - replay).abs().max()) / largest
                                     for x in (cli, merged_out, plain))
        bit_equal = torch.equal(cli, replay)
    del model
    drift = score_diff(runs["fused"]["scores"], runs["solo"]["scores"])
    if not (d_live <= LIVE_EVAL_TOL < d_merged and d_plain <= W8A8_EVAL_DRIFT
            and drift <= W8A8_EVAL_DRIFT):
        raise RuntimeError(
            f"LoRA eval: against the live model's replay, the CLI's fused scores {d_live} (tol "
            f"{LIVE_EVAL_TOL}), the merged control's {d_merged} (must exceed it), the plain "
            f"attention's {d_plain} (tol {W8A8_EVAL_DRIFT}); fused against the solo eval "
            f"{drift} (tol {W8A8_EVAL_DRIFT})")
    line = [ln for ln in runs["fused"]["printed"].splitlines() if ln.startswith("fused eval:")]
    phase("lora", f"13b cli.stage2_eval.main --eval_w8a8 True, --use_*_lora {LORA_RANK}, "
          f"the LoRA checkpoint, phase 10b's meta files ({n_videos} videos, batch {BATCH}): "
          f"{n_vit + n_llm} K1 launches per forward, no quantize feed under the live adapters; "
          f"against the live W8A8 model built outside the CLI, replayed on the CLI's {batches} "
          f"recorded batches: the CLI's fused scores {d_live:.3e} of the largest (tol "
          f"{LIVE_EVAL_TOL}; bit-equal {bit_equal}), the merged control's "
          f"{d_merged:.3e} (must exceed the tol), the replay with the plain attention "
          f"{d_plain:.3e} (tol {W8A8_EVAL_DRIFT}); W8A8 fused (live adapters) against the solo "
          f"eval (no W8A8, as in JAX): {drift:.3e} (tol {W8A8_EVAL_DRIFT}); whole calls (s) solo "
          f"{runs['solo']['s']:.1f}, fused live {runs['fused']['s']:.1f}, fused merged "
          f"{control['s']:.1f}, phase 10b's W8A8 fused without adapters "
          f"{eval_s.get('fused_w8a8', float('nan')):.1f}; peak GiB "
          + ", ".join(f"{k} {v['peak_gib']:.2f}" for k, v in runs.items())
          + f"; {line[0] if line else 'no fused eval line'} [{smi}]")
    return {k: dict(s=v["s"], peak_gib=v["peak_gib"]) for k, v in runs.items()}


def run_lora_generation(ref, lcfg, merged, device, ids, px_u8, smi, *, n_vit: int,
                        n_llm: int) -> dict:
    """Phase 13c: greedy generation in bf16 with the LoRA checkpoint's
    adapters live (the cache path through their row-major calls), against
    the same checkpoint merged (`merged_checkpoint`)."""
    from aigv_assessor_torch.cli.score import build_serving_model
    from aigv_assessor_torch.models.generation import GenerationConfig, generate
    from aigv_assessor_torch.ops import decode_attention as dec
    from aigv_assessor_torch.ops import flash_attention as fa
    from aigv_assessor_torch.ops.preprocess import resize_normalize

    weights = ref.state_dict()
    gcfg = GenerationConfig(max_new_tokens=LORA_GEN_TOKENS, eos_token_id=-1)
    counters = (dec.cached_decode_attention, dec.decode_attention, fa.flash_attention_qkv,
                fa.flash_attention)
    steps = LORA_GEN_TOKENS - 1
    out = {}
    with torch.inference_mode():
        pv = resize_normalize(px_u8, size=IMAGE, dtype=torch.bfloat16)
        for label, (config, state) in (("live", (lcfg, weights)), ("merged", merged)):
            model = build_serving_model(config, device=device, seed=0, weights=state)
            generate(model, None, ids, pv, gcfg=GenerationConfig(max_new_tokens=2,
                                                                 eos_token_id=-1),
                     with_motion=True)  # warm-up
            torch.cuda.synchronize()
            for c in counters:
                c.launches = 0
            t0 = time.perf_counter()
            tokens = generate(model, None, ids, pv, gcfg=gcfg, with_motion=True)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            counts = {c.__name__: c.launches for c in counters}
            want = dict(cached_decode_attention=n_llm * steps, decode_attention=0,
                        flash_attention_qkv=n_vit, flash_attention=0)
            if counts != want or tuple(tokens.shape) != (ids.shape[0], LORA_GEN_TOKENS):
                raise RuntimeError(f"LoRA generation {label}: launches {counts}, expected "
                                   f"{want}; tokens {tuple(tokens.shape)}")
            out[label] = dict(tokens=torch.as_tensor(tokens).cpu(), ms=ms, counts=counts)
            del model
            gc.collect()
            torch.cuda.empty_cache()
    live, merged = out["live"]["tokens"], out["merged"]["tokens"]
    parted = [int(np.argmax((live[b] != merged[b]).numpy())) if not torch.equal(live[b], merged[b])
              else None for b in range(live.shape[0])]
    phase("lora", f"13c generation bf16 InternVL2-2B, r={LORA_RANK} adapters live, "
          f"{ids.shape[0]} x {ids.shape[1]}-token prompts, {LORA_GEN_TOKENS} greedy tokens: "
          f"launches {out['live']['counts']} ({n_llm} K8 a step), {out['live']['ms']:.1f} ms "
          f"(merged {out['merged']['ms']:.1f} ms); ids equal to the merged model's: "
          f"{[p is None for p in parted]}, first differing step per video {parted}; live "
          f"{live.tolist()}, merged {merged.tolist()} [{smi}]")
    out["parted"] = parted
    return out


def run_26b_quantized(device, ids, mask, px_u8, videos, ids_pn, mask_pn, smi,
                      bf16_cut_readout: torch.Tensor) -> dict:
    """Phase 13d: InternVL2-26B in W8A8 and int4 at full depth and int8 at
    DEPTH_CUT layers per tower, built tensor by tensor from seed 0 -> per
    mode its memory, times and launches."""
    from aigv_assessor_torch.cli.score import build_serving_model, score_batch, score_chunks
    from aigv_assessor_torch.models.assessor import AIGVAssessor
    from aigv_assessor_torch.ops import flash_attention as fa
    from aigv_assessor_torch.ops import int8_matmul as wo
    from aigv_assessor_torch.ops import quant_fuse as qf
    from aigv_assessor_torch.ops.preprocess import resize_normalize

    counters = (fa.flash_attention_qkv, fa.flash_attention, wo.int8_matmul, wo.int4_matmul,
                qf.layernorm_quant, qf.gelu_quant, qf.quant_rows, qf.rmsnorm_quant,
                qf.silu_mul_quant)
    swaps = ((fa, "flash_attention_qkv", fa.plain_attention_qkv),
             (fa, "flash_attention", fa.plain_flash_attention),
             (wo, "int8_matmul", wo.plain_int8_matmul), (wo, "int4_matmul", wo.plain_int4_matmul),
             (qf, "gelu_quant", qf.plain_gelu_quant), (qf, "layernorm_quant",
                                                       qf.plain_layernorm_quant),
             (qf, "quant_rows", qf.plain_quant_rows))
    # phase 11's input, made the same way
    pv = resize_normalize(px_u8, size=IMAGE, dtype=torch.float32).to(torch.bfloat16)
    out = {}
    for mode, depth in (("w8a8", None), ("int8", DEPTH_CUT), ("int4", None)):
        gc.collect()
        torch.cuda.empty_cache()
        row = {}
        for layers in sorted({DEPTH_CUT, depth}, key=lambda x: x or 10**6):
            cfg = internvl2_26b(layers)
            n_vit, n_llm = cfg.vision.num_hidden_layers, cfg.llm.num_hidden_layers
            held = torch.cuda.memory_allocated(device)
            torch.cuda.reset_peak_memory_stats(device)
            t0 = time.perf_counter()
            model = build_serving_model(cfg, device=device, seed=0, **{mode: True})
            torch.cuda.synchronize()
            init_s = time.perf_counter() - t0
            build_gib = (torch.cuda.max_memory_allocated(device) - held) / 2**30
            weights_gib = (torch.cuda.memory_allocated(device) - held) / 2**30
            with torch.device("meta"):
                sizes = [t.numel() for t in AIGVAssessor(cfg).state_dict().values()]
            fp32_gib, largest_gib = (4 * n / 2**30 for n in (sum(sizes), max(sizes)))
            if not build_gib - weights_gib <= BUILD_OVER_LARGEST * largest_gib:
                raise RuntimeError(f"26B {mode} x{n_vit}: the build peaked at {build_gib} GiB, "
                                   f"{build_gib - weights_gib} above its weights; the largest "
                                   f"fp32 tensor is {largest_gib} GiB (tol {BUILD_OVER_LARGEST}x)"
                                   f", an fp32 copy of the model {fp32_gib} GiB")
            row.setdefault("builds", []).append(
                f"{n_vit} + {n_llm} layers: peak {build_gib:.2f}, weights {weights_gib:.2f}, "
                f"{build_gib - weights_gib:.2f} above them (tol {BUILD_OVER_LARGEST} x the "
                f"largest fp32 tensor, {largest_gib:.2f}; an fp32 copy {fp32_gib:.2f})")
            if layers == DEPTH_CUT:
                with torch.inference_mode():
                    k = model(ids[:, 0], pv, mask[:, 0])["readout"].float()
                    with contextlib.ExitStack() as stack:
                        for module, name, plain in swaps:
                            stack.enter_context(mock.patch.object(module, name, plain))
                        p_ = model(ids[:, 0], pv, mask[:, 0])["readout"].float()
                tol = W8A8_READOUT_TOL if mode == "w8a8" else WEIGHT_ONLY_READOUT_TOL
                rel_kp, rel_kb = relative_l2(k, p_), relative_l2(k, bf16_cut_readout)
                if not torch.isfinite(k).all() or not rel_kp <= tol:
                    raise RuntimeError(f"26B {mode} x{DEPTH_CUT}: readout kernel vs plain "
                                       f"{rel_kp} (tol {tol})")
                row.update(cut_kernel_plain=rel_kp, cut_kernel_bf16=rel_kb)
            if layers == depth:
                score_batch(model, ids, px_u8, mask)  # warm-up
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats(device)
                for c in counters:
                    c.launches = 0
                t0 = time.perf_counter()
                rows = score_chunks(model, [list(videos[:BATCH])], ids_pn, mask_pn,
                                    batch_size=BATCH)
                torch.cuda.synchronize()
                chunk_ms = (time.perf_counter() - t0) * 1e3
                peak = (torch.cuda.max_memory_allocated(device) - held) / 2**30
                counts = {c.__name__: c.launches for c in counters}
                want = dict.fromkeys(counts, 0)
                gelu = n_vit if cfg.vision.approximate_gelu else 0
                if mode == "w8a8":  # the QK-normalized tower's RMSNorm feeds stay unfused
                    want.update(flash_attention=n_vit, flash_attention_qkv=n_llm,
                                gelu_quant=gelu)
                else:
                    want.update(flash_attention=n_vit + n_llm, **{f"{mode}_matmul": 5 * n_llm})
                if counts != want or not np.isfinite(np.asarray(rows)).all():
                    raise RuntimeError(f"26B {mode} x{n_vit}: launches {counts}, expected {want}")
                row.update(depth=(n_vit, n_llm), counts=counts, ms=chunk_ms, peak_gib=peak,
                           weights_gib=weights_gib, build_gib=build_gib, fp32_gib=fp32_gib,
                           init_s=init_s)
            del model
            gc.collect()
            torch.cuda.empty_cache()
        out[mode] = row
        phase("26b", f"13d InternVL2-26B {mode}, {row['depth'][0]} + {row['depth'][1]} layers, "
              f"built tensor by tensor from seed 0: weights {row['weights_gib']:.2f} GiB, the "
              f"build's peak {row['build_gib']:.2f} GiB allocated (an fp32 copy: "
              f"{row['fp32_gib']:.2f} GiB); each build, GiB: {'; '.join(row['builds'])}; init "
              f"{row['init_s']:.1f} s; one chunk of {BATCH} "
              f"videos x {FRAMES} frames {IMAGE}px: {row['ms']:.1f} ms/chunk, peak "
              f"{row['peak_gib']:.2f} GiB; launches per forward "
              f"{ {k_: v for k_, v in row['counts'].items() if v} }; at {DEPTH_CUT} layers per "
              f"tower readout rel L2 kernel vs plain {row['cut_kernel_plain']:.3e}, vs the bf16 "
              f"26B readout {row['cut_kernel_bf16']:.3e} [{smi}]")
    return out


def run_remat_policy(cfg, device, ids, mask, px_u8, smi, *, full_ms: float,
                     full_peak: float) -> dict:
    """Phase 13e: stage-2 LoRA training of the 2B model with the ViT under
    REMAT_POLICY, against phase 7's whole-layer recompute (full_ms,
    full_peak): the adapters' gradients of one training step's loss under
    both, then TRAIN_STEPS steps under the policy."""
    from aigv_assessor_torch.cli.stage2_train import (
        build_training_model, prepare_batch, train_steps)
    from aigv_assessor_torch.models.lora import set_generator
    from aigv_assessor_torch.ops import flash_attention as fa
    from aigv_assessor_torch.train.trainer import TrainConfig, Trainer

    lora_cfg = cfg.replace(use_backbone_lora=LORA_RANK, use_llm_lora=LORA_RANK)
    mos = torch.as_tensor(np.random.default_rng(5).uniform(20.0, 90.0, ids.shape[0]),
                          dtype=torch.float32)
    batch = {"input_ids": ids[:, 0], "pixels_u8": px_u8, "attention_mask": mask[:, 0],
             "mos": mos}
    kernels = (fa.flash_attention_qkv_lse, fa.flash_attention_qkv_bwd_kernel)
    grads, out = {}, {}
    for label, policy in (("full", None), ("policy", REMAT_POLICY)):
        with tempfile.TemporaryDirectory() as out_dir:
            tc = TrainConfig(output_dir=out_dir, learning_rate=TRAIN_LR, warmup_ratio=0.0,
                             lr_scheduler_type="constant", num_train_epochs=1, save_steps=0,
                             seed=0)
            model = build_training_model(lora_cfg, device=device, seed=0, train_config=tc,
                                         vit_remat_policy=policy)
            opened_score_head(model)
            trainer = Trainer(model, tc, TRAIN_STEPS)
            trainable = trainer.trainable_parameters()
            prepared = prepare_batch(model, **batch)
            # one training-mode pass: dropout and drop path from one seed
            model.train()
            set_generator(model, torch.Generator(device=device).manual_seed(5))
            for c in kernels:
                c.launches = 0
            loss = model(prepared["input_ids"], prepared["pixel_values"],
                         prepared["attention_mask"], mos=prepared["mos"])["loss"]
            loss.backward()
            grads[label] = torch.cat([p.grad.float().flatten() for p in trainable.values()])
            out[label] = dict(counts={c.__name__: c.launches for c in kernels})
            for p in trainable.values():
                p.grad = None
            if policy:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats(device)
                train_steps(model, [batch] * TRAIN_STEPS, tc, trainer=trainer)
                torch.cuda.synchronize()
                with open(f"{out_dir}/train_log.jsonl") as f:
                    log = [json.loads(line) for line in f]
                out[label].update(
                    ms=(log[-1]["time"] - log[-2]["time"]) * 1e3,
                    peak_gib=torch.cuda.max_memory_allocated(device) / 2**30,
                    losses=[r["loss"] for r in log])
            del model, trainer, trainable, prepared, loss
            gc.collect()
            torch.cuda.empty_cache()
    n = cfg.vision.num_hidden_layers + cfg.llm.num_hidden_layers
    want = {"flash_attention_qkv_lse": 2 * n, "flash_attention_qkv_bwd_kernel": n}
    if out["full"]["counts"] != want or out["policy"]["counts"] != want:
        raise RuntimeError(f"remat policy: launches {out}, expected {want} (the attention "
                           "recomputed under both)")
    g_full, g_pol = grads["full"], grads["policy"]
    bit_equal = torch.equal(g_full, g_pol)
    rel = relative_l2(g_pol, g_full)
    losses = out["policy"]["losses"]
    if not torch.isfinite(g_pol).all() or not rel <= TRAIN_GRAD_TOL or not np.isfinite(losses).all():
        raise RuntimeError(f"remat policy: gradients {rel} from whole-layer recompute (tol "
                           f"{TRAIN_GRAD_TOL}); losses {losses}")
    phase("train", f"13e stage-2 LoRA training InternVL2-2B, r={LORA_RANK}, the ViT under "
          f"vit_remat_policy={REMAT_POLICY}: launches per micro-batch {out['policy']['counts']} "
          f"(the attention recomputed, as under whole-layer recompute); {TRAIN_STEPS} steps "
          f"{out['policy']['ms']:.1f} ms/step (the last; phase 7's whole-layer recompute "
          f"{full_ms:.1f}), peak {out['policy']['peak_gib']:.2f} GiB allocated (phase 7 "
          f"{full_peak:.2f}); losses {np.round(losses, 5).tolist()}; the adapters' and score "
          f"head's gradients of one training-mode step ({g_pol.numel()} values, dropout and "
          f"drop path from one seed) against whole-layer recompute: bit-equal {bit_equal}, rel "
          f"L2 {rel:.3e} (tol {TRAIN_GRAD_TOL}) [{smi}]")
    out.update(bit_equal=bit_equal, rel_l2=rel)
    return out


def run_vit_grids(cfg, device, smi, *, n_vit: int) -> dict:
    """Phase 13f: the 2B ViT (bf16, seed 0) at VIT_SIZE px, its position
    embedding resized to the 24 x 24 grid (577 tokens padded to 584), and at
    select_layer -2, each against the same forward on the plain attention."""
    from aigv_assessor_torch.core.precision import Precision
    from aigv_assessor_torch.models.loading import init_random_
    from aigv_assessor_torch.models.vit import InternVisionModel
    from aigv_assessor_torch.ops import flash_attention as fa
    from aigv_assessor_torch.ops.preprocess import resize_normalize

    with torch.device("meta"):
        vit = InternVisionModel(cfg.vision, Precision())
    vit = init_random_(vit.to(torch.bfloat16).to_empty(device=device), 0).eval()
    out = {}
    for label, size, select in (("336px", VIT_SIZE, -1), ("select_layer_-2", IMAGE, -2)):
        u8 = torch.randint(0, 256, (1, FRAMES, size, size, 3), dtype=torch.uint8, device=device,
                           generator=torch.Generator(device=device).manual_seed(size))
        pv = resize_normalize(u8, size=size, dtype=torch.bfloat16)[0]
        with torch.inference_mode():
            vit(pv, select_layer=select)  # warm-up
            fa.flash_attention_qkv.launches = 0
            ms = time_ms(lambda: vit(pv, select_layer=select), 3, warmup=0)
            launches = fa.flash_attention_qkv.launches // 3
            k = vit(pv, select_layer=select).float()
            with mock.patch.object(fa, "flash_attention_qkv", fa.plain_attention_qkv):
                p_ = vit(pv, select_layer=select).float()
        tokens = 1 + (size // cfg.vision.patch_size) ** 2
        want = n_vit if select == -1 else select % (n_vit + 1)
        rel = relative_l2(k, p_)
        if (launches != want or tuple(k.shape) != (FRAMES, tokens, cfg.vision.hidden_size)
                or not torch.isfinite(k).all() or not rel <= READOUT_TOL):
            raise RuntimeError(f"ViT {label}: {launches} launches (expected {want}), shape "
                               f"{tuple(k.shape)}, kernel vs plain {rel} (tol {READOUT_TOL})")
        out[label] = dict(launches=launches, ms=ms, rel=rel, tokens=tokens)
    phase("vit", f"13f the InternVL2-2B ViT, {FRAMES} frames: at {VIT_SIZE}px "
          f"({out['336px']['tokens']} tokens padded to {-(-out['336px']['tokens'] // 8) * 8}, "
          f"the position embedding resized to a {VIT_SIZE // 14} x {VIT_SIZE // 14} grid) "
          f"{out['336px']['launches']} K1 launches, {out['336px']['ms']:.2f} ms a forward, "
          f"output rel L2 kernel vs plain {out['336px']['rel']:.3e}; at select_layer -2 "
          f"({IMAGE}px) {out['select_layer_-2']['launches']} launches, "
          f"{out['select_layer_-2']['ms']:.2f} ms, {out['select_layer_-2']['rel']:.3e} (tol "
          f"{READOUT_TOL}) [{smi}]")
    del vit
    torch.cuda.empty_cache()
    return out


# phase 14: checkpoints and frames from disk
PHASE14_BUDGET_S = 180  # the phase's wall-time target
PHASE14_SCALE = "2b"  # the --model_scale of phase 14's model
# 14d-e run at this depth per tower (phase 13's DEPTH_CUT): their files at
# full depth would hold the phase far over PHASE14_BUDGET_S
PHASE14_CUT = 2
RESIZE_FP32_TOL = 1e-6  # card against CPU, the normalized fp32 frames
RESIZE_BF16_ULP_SHARE = 1e-4  # bf16 elements one ulp from the CPU's at most
RESIZE_HD = (720, 1280)  # the second batch's frame size (H, W)


def readout(model, ids, pv, mask) -> torch.Tensor:
    """The score head's input of one forward (the first perspective)."""
    with torch.inference_mode():
        return model(ids[:, 0], pv.to(model.precision.compute_dtype), mask[:, 0])["readout"].float()


def remove(*paths) -> None:
    """Delete artifacts (files or directories) after their check."""
    import shutil

    for p in paths:
        if os.path.isdir(p):
            shutil.rmtree(p)
        elif os.path.exists(p):
            os.remove(p)


def run_resize(device, smi, ids, mask, *, n_vit: int, n_llm: int) -> dict:
    """Phase 14a: phase 10's mp4 frames decoded at their own 640x360 and a
    720x1280 batch through `resize_normalize(size=448)` on the card against
    the same call on the CPU (fp32 within RESIZE_FP32_TOL; bf16 equal or one
    ulp in at most RESIZE_BF16_ULP_SHARE of the elements); one chunk scored
    from the resized frames (48 K1 launches); ms per chunk of the resize."""
    from aigv_assessor_torch.cli.common import build_serving_model
    from aigv_assessor_torch.data.video import load_video
    from aigv_assessor_torch.ops import flash_attention as fa
    from aigv_assessor_torch.ops.preprocess import resize_normalize

    with tempfile.TemporaryDirectory() as d:
        write_cli_videos(d)
        clips = [np.stack([np.asarray(f.convert("RGB")) for f in
                           load_video(os.path.join(d, f"video{i}.mp4"), num_segments=FRAMES)])
                 for i in range(BATCH)]
    rng = np.random.default_rng(14)
    batches = {f"{CLI_SIZE[1]}x{CLI_SIZE[0]}": np.stack(clips),
               f"{RESIZE_HD[0]}x{RESIZE_HD[1]}": rng.integers(
                   0, 256, (BATCH, FRAMES, *RESIZE_HD, 3), dtype=np.uint8)}
    out, cards = {}, {}
    for label, frames in batches.items():
        cpu = torch.from_numpy(frames)
        card = cards[label] = cpu.to(device)
        f32 = resize_normalize(card, size=IMAGE, dtype=torch.float32)
        ref32 = resize_normalize(cpu, size=IMAGE, dtype=torch.float32)
        err = (f32.cpu() - ref32).abs().max().item()
        b16 = resize_normalize(card, size=IMAGE, dtype=torch.bfloat16).cpu()
        ref16 = resize_normalize(cpu, size=IMAGE, dtype=torch.bfloat16)
        diff = (b16.view(torch.int16).int() - ref16.view(torch.int16).int()).abs()
        share = (diff > 0).float().mean().item()
        if (tuple(f32.shape) != (BATCH, FRAMES, IMAGE, IMAGE, 3) or not err <= RESIZE_FP32_TOL
                or diff.max().item() > 1 or not share <= RESIZE_BF16_ULP_SHARE):
            raise RuntimeError(f"resize {label}: shape {tuple(f32.shape)}, fp32 card vs CPU "
                               f"{err} (tol {RESIZE_FP32_TOL}), bf16 {diff.max().item()} ulp "
                               f"in {share} of the elements")
        ms = time_ms(lambda: resize_normalize(card, size=IMAGE, dtype=torch.bfloat16), 10)
        out[label] = dict(err=err, share=share, ms=ms)
    cfg = phase14_config()
    model = build_serving_model(cfg, device=device, seed=0)
    ids = phase14_prompt(ids, cfg.img_context_token_id)
    label = next(iter(batches))
    pv = resize_normalize(cards[label], size=IMAGE, dtype=torch.bfloat16)
    del cards
    readout(model, ids, pv, mask)  # warm-up
    fa.flash_attention_qkv.launches = 0
    r = readout(model, ids, pv, mask)
    launches = fa.flash_attention_qkv.launches
    if launches != n_vit + n_llm or not torch.isfinite(r).all():
        raise RuntimeError(f"resize: the chunk launched K1 {launches} times (expected "
                           f"{n_vit + n_llm}); readout finite {bool(torch.isfinite(r).all())}")
    out["chunk_launches"] = launches
    del model
    torch.cuda.empty_cache()
    phase("ckpt", "14a resize_normalize(size=448) on the card, " + "; ".join(
        f"{BATCH} x {FRAMES} frames at {k}: {v['ms']:.3f} ms a chunk (bf16 out), fp32 card vs "
        f"CPU {v['err']:.2e} (tol {RESIZE_FP32_TOL}), bf16 one ulp in {v['share']:.2e} of the "
        f"elements (tol {RESIZE_BF16_ULP_SHARE})" for k, v in out.items() if k in batches)
        + f"; one chunk scored from the {label} mp4 frames: {launches} K1 launches [{smi}]")
    return out


def phase14_config(layers=None):
    """The config the score CLI builds with `--model_scale PHASE14_SCALE`
    (its `<IMG_CONTEXT>` id the test tokenizer's), with `layers` per tower
    where given."""
    from aigv_assessor_torch.cli import common

    cfg = common.config_and_tokenizer(common.serving_args(model_scale=PHASE14_SCALE), 2)[0]
    if layers is None:
        return cfg
    return cfg.replace(vision=dataclasses.replace(cfg.vision, num_hidden_layers=layers),
                       llm=dataclasses.replace(cfg.llm, num_hidden_layers=layers))


def phase14_prompt(ids: torch.Tensor, ctx: int) -> torch.Tensor:
    """The synthetic prompts with the `<IMG_CONTEXT>` slots (CTX) holding
    `ctx`, and no other token equal to it."""
    out = torch.where(ids == ctx, torch.full_like(ids, 10), ids)
    return torch.where(ids == CTX, torch.full_like(ids, ctx), out)


def run_checkpoint_files(device, smi, work: str, ids, mask, px_u8, *, n_vit: int,
                         n_llm: int) -> dict:
    """Phase 14b-c in `work` (each artifact deleted after its check): the
    2B model's fp32 JAX tree as `params.safetensors` served by
    `cli.score.main` against the seed, and its start-up; `tools.convert_to_int8`
    files served under --int8 / --int4 / --w8a8; a reference-format bf16
    checkpoint's start-up (its numpy draw on a host thread meanwhile)."""
    from aigv_assessor_torch.cli import common
    from aigv_assessor_torch.cli import score
    from aigv_assessor_torch.core.precision import Precision
    from aigv_assessor_torch.data.tokenizer import build_test_tokenizer
    from aigv_assessor_torch.models.assessor import AIGVAssessor
    from aigv_assessor_torch.models.loading import (
        jax_tree, load_jax_params, load_reference_checkpoint, save_jax_params,
        state_dict_from_jax)
    from aigv_assessor_torch.ops import flash_attention as fa
    from aigv_assessor_torch.ops import int8_matmul as wo
    from aigv_assessor_torch.ops import quant_fuse as qf
    from aigv_assessor_torch.ops.preprocess import resize_normalize
    from aigv_assessor_torch.tools import convert_to_int8, make_synthetic_ckpt

    from concurrent.futures import ThreadPoolExecutor

    out = {}
    cfg = phase14_config()
    tok = build_test_tokenizer()
    ids = phase14_prompt(ids, cfg.img_context_token_id)
    pv = resize_normalize(px_u8, size=IMAGE, dtype=torch.bfloat16)

    # the reference format at PHASE14_CUT layers per tower: the format's path
    # is depth-free, and full depth cost the smoke ~40 s of numpy and disk
    ref_cfg = phase14_config(PHASE14_CUT)

    def draw_reference():
        """The reference-format tensors from seed 0 (numpy, one host core),
        drawn beside 14b-c's card work -> (state dict, seconds)."""
        t0 = time.perf_counter()
        rng = np.random.default_rng(0)
        sd = make_synthetic_ckpt.reference_state_dict(ref_cfg, rng)
        sd.update(make_synthetic_ckpt.slowfast_state_dict(ref_cfg, rng))
        return sd, time.perf_counter() - t0

    pool = ThreadPoolExecutor(1)
    drawn = pool.submit(draw_reference)

    # 14b: the fp32 tree to disk, then the CLI from it and from the seed
    t_b = time.perf_counter()
    ckpt = os.path.join(work, "fp32")
    os.makedirs(ckpt)
    t0 = time.perf_counter()
    model = common.build_serving_model(cfg, device=device, precision=Precision.fp32(), seed=0)
    tree = jax_tree(model)
    del model
    torch.cuda.empty_cache()
    tree_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    save_jax_params(os.path.join(ckpt, "params.safetensors"), tree)
    del tree
    make_synthetic_ckpt.write_config_and_tokenizer(cfg, tok, ckpt)
    write_s = time.perf_counter() - t0
    file_gb = os.path.getsize(os.path.join(ckpt, "params.safetensors")) / 1e9
    with tempfile.TemporaryDirectory(dir=work) as videos:
        write_cli_videos(videos)
        rows = {}
        build = common.build_serving_model
        with mock.patch.object(common, "build_serving_model",
                               lambda *a, **kw: opened_score_head(build(*a, **kw))):
            for label, flags in (("seed", []), ("params", ["--model_name_or_path", ckpt])):
                argv = ["--videos", videos, "--batch_size", str(BATCH), "--num_segments",
                        str(FRAMES), "--out", os.path.join(videos, f"{label}.csv"),
                        "--device", str(device), "--model_scale", PHASE14_SCALE, *flags]
                with contextlib.redirect_stdout(io.StringIO()):
                    rows[label] = [r[1:] for r in score.main(argv)]
    if rows["params"] != rows["seed"] or not np.any(np.asarray(rows["seed"])):
        raise RuntimeError(f"14b: scores from params.safetensors {rows['params']} are not the "
                           f"seed's {rows['seed']}")
    # start-up alone: read, build, weights on the card
    args = common.serving_args(ckpt, PHASE14_SCALE)
    t0 = time.perf_counter()
    weights = common.model_weights(args, cfg)
    read_s = time.perf_counter() - t0
    model = common.build_serving_model(cfg, device=device, seed=0, weights=weights)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0 - read_s
    del model  # `weights`, the file's, stay for 14c's in-memory builds
    torch.cuda.empty_cache()
    out["startup"] = dict(read_s=read_s, build_s=build_s)
    phase("ckpt", f"14b the 2B model's fp32 JAX tree ({file_gb:.2f} GB params.safetensors, "
          f"drawn on the card and copied to the host in {tree_s:.1f} s, written with config.json "
          f"and tokenizer.json in {write_s:.1f} s): cli.score.main --model_name_or_path gives the "
          f"seed's scores bit for bit on {len(rows['seed'])} videos; start-up from it: read "
          f"{read_s:.2f} s, build and weights on the card {build_s:.2f} s; "
          f"{time.perf_counter() - t_b:.1f} s in all [{smi}]")

    # 14c: stored int8 / int4 trees
    counters = (fa.flash_attention_qkv, fa.flash_attention, wo.int8_matmul, wo.int4_matmul,
                qf.layernorm_quant, qf.gelu_quant, qf.quant_rows, qf.rmsnorm_quant,
                qf.silu_mul_quant)

    def served(path, **mode):
        """(readout, launches of one forward) of the serving stack on `path`."""
        _, m, _ = common.build_serving_stack(path, model_scale=PHASE14_SCALE, device=device,
                                             **mode)
        readout(m, ids, pv, mask)  # warm-up
        for c in counters:
            c.launches = 0
        r = readout(m, ids, pv, mask)
        counts = {c.__name__: c.launches for c in counters if c.launches}
        del m
        torch.cuda.empty_cache()
        return r, counts

    t_c = time.perf_counter()
    for bits in (8, 4):
        qdir = os.path.join(work, f"int{bits}")
        os.makedirs(qdir)
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            convert_to_int8.main(["--params", os.path.join(ckpt, "params.safetensors"),
                                  "--out", os.path.join(qdir, "params.safetensors"),
                                  "--bits", str(bits)])
        make_synthetic_ckpt.write_config_and_tokenizer(cfg, tok, qdir)
        convert_s = time.perf_counter() - t0
        mode = {f"int{bits}": True}
        r_file, counts = served(qdir, **mode)
        in_memory = common.build_serving_model(cfg, device=device, seed=0, weights=weights,
                                               **mode)
        r_mem = readout(in_memory, ids, pv, mask)
        del in_memory
        torch.cuda.empty_cache()
        want = {"flash_attention_qkv": n_vit, "flash_attention": n_llm,
                f"int{bits}_matmul": 5 * n_llm}
        if not torch.equal(r_file, r_mem) or counts != want:
            raise RuntimeError(f"14c int{bits}: the stored file's readout differs from the "
                               f"in-memory build's by {(r_file - r_mem).abs().max().item()}; "
                               f"launches {counts}, expected {want}")
        out[f"int{bits}"] = dict(convert_s=convert_s, counts=counts,
                                 file_gb=os.path.getsize(os.path.join(qdir, "params.safetensors"))
                                 / 1e9)
        if bits == 8:  # --w8a8 over the int8 file, against the host's dequantize-then-quantize
            r_w8, counts8 = served(qdir, w8a8=True)
            host = convert_to_int8.dequantize_tree(load_jax_params(qdir))
            with contextlib.redirect_stdout(io.StringIO()):
                host = convert_to_int8.quantize_tree(
                    host, scope=("language_model", "vision_model"), exclude=("output", "o_proj"),
                    only_base=True)
            w8a8 = Precision(w8a8=True)
            with torch.device("meta"):
                control = AIGVAssessor(cfg, w8a8)
            control = control.to(torch.bfloat16).to_empty(device=device)
            control.load_state_dict(state_dict_from_jax(host, cfg, w8a8), strict=True)
            del host
            r_host = readout(control.eval(), ids, pv, mask)
            del control
            torch.cuda.empty_cache()
            want8 = {"flash_attention_qkv": n_vit + n_llm, "layernorm_quant": 2 * n_vit,
                     "gelu_quant": n_vit, "quant_rows": n_vit}
            if not torch.equal(r_w8, r_host) or counts8 != want8:
                raise RuntimeError(f"14c --w8a8 over the int8 file: readout "
                                   f"{(r_w8 - r_host).abs().max().item()} from the host's "
                                   f"dequantize-then-quantize; launches {counts8}, expected "
                                   f"{want8}")
            out["w8a8"] = dict(counts=counts8)
        remove(qdir)
    phase("ckpt", f"14c tools.convert_to_int8 on 14b's file: --bits 8 "
          f"({out['int8']['file_gb']:.2f} GB, {out['int8']['convert_s']:.1f} s) served under "
          f"--int8 bit-equal to the in-memory int8 build, launches {out['int8']['counts']}; "
          f"--bits 4 ({out['int4']['file_gb']:.2f} GB, {out['int4']['convert_s']:.1f} s) under "
          f"--int4 bit-equal, launches {out['int4']['counts']}; the int8 file under --w8a8 "
          f"bit-equal to JAX's dequantize-then-quantize on the host, launches "
          f"{out['w8a8']['counts']}; {time.perf_counter() - t_c:.1f} s in all [{smi}]")
    del weights
    remove(ckpt)

    # 14b, the reference format: sharded bf16 safetensors under the
    # reference's names, drawn beside the steps above
    t_r = time.perf_counter()
    sd, draw_s = drawn.result()
    pool.shutdown()
    wait_s = time.perf_counter() - t_r
    ref_dir = os.path.join(work, "reference")
    os.makedirs(ref_dir)
    t0 = time.perf_counter()
    make_synthetic_ckpt.write_sharded_safetensors(sd, ref_dir, n_shards=4)
    make_synthetic_ckpt.write_config_and_tokenizer(ref_cfg, tok, ref_dir)
    del sd
    ref_write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    weights = load_reference_checkpoint(ref_dir, ref_cfg)
    ref_read_s = time.perf_counter() - t0
    model = common.build_serving_model(ref_cfg, device=device, seed=0, weights=weights)
    torch.cuda.synchronize()
    ref_build_s = time.perf_counter() - t0 - ref_read_s
    if not torch.isfinite(readout(model, ids, pv, mask)).all():
        raise RuntimeError("14b: the reference-format checkpoint's readout is not finite")
    del model, weights
    remove(ref_dir)
    torch.cuda.empty_cache()
    out["startup"].update(ref_read_s=ref_read_s, ref_build_s=ref_build_s)
    phase("ckpt", f"14b a reference-format bf16 checkpoint of the 2B model at {PHASE14_CUT} layers "
          f"per tower (4 shards; numpy drew "
          f"it in {draw_s:.1f} s on a host thread beside 14b-c, {wait_s:.1f} s waited for; "
          f"written in {ref_write_s:.1f} s): start-up load_reference_checkpoint "
          f"{ref_read_s:.2f} s, build and weights on the card {ref_build_s:.2f} s; "
          f"{time.perf_counter() - t_r:.1f} s in all [{smi}]")
    return out


def run_grafts(device, smi, work: str, ids, mask, px_u8, *, layers: int) -> None:
    """Phase 14e at `layers` per tower: a model's fp32 tree on disk through
    `tools.extract_vit`, `extract_mlp` and `replace_llm`, the parts grafted
    by `--vision_path` / `--llm_path` / `--mlp_path` over the seed-1 model
    (a directory with the config alone): readout bit-equal to seed 1's
    weights with the tree's three subtrees."""
    from aigv_assessor_torch.cli import common
    from aigv_assessor_torch.cli.args import parse_args
    from aigv_assessor_torch.core.precision import Precision
    from aigv_assessor_torch.data.tokenizer import build_test_tokenizer
    from aigv_assessor_torch.models.loading import jax_tree, save_jax_params, state_dict_from_jax
    from aigv_assessor_torch.ops.preprocess import resize_normalize
    from aigv_assessor_torch.tools import (
        extract_mlp, extract_vit, make_synthetic_ckpt, replace_llm)

    cfg = phase14_config(layers)
    tok = build_test_tokenizer()
    ids = phase14_prompt(ids, cfg.img_context_token_id)
    pv = resize_normalize(px_u8, size=IMAGE, dtype=torch.bfloat16)
    src, base = os.path.join(work, "graft_src.safetensors"), os.path.join(work, "graft_base")
    os.makedirs(base)
    make_synthetic_ckpt.write_config_and_tokenizer(cfg, tok, base)  # no weights: the seed
    model = common.build_serving_model(cfg, device=device, precision=Precision.fp32(), seed=0)
    tree = jax_tree(model)
    del model
    save_jax_params(src, tree)
    t0 = time.perf_counter()
    parts = {name: os.path.join(work, f"{name}.safetensors") for name in ("vit", "mlp", "llm")}
    with contextlib.redirect_stdout(io.StringIO()):
        extract_vit.main(["--params", src, "--out", parts["vit"]])
        extract_mlp.main(["--params", src, "--out", parts["mlp"]])
        replace_llm.main(["--params", parts["mlp"], "--llm_params", src, "--out", parts["llm"]])
    tools_s = time.perf_counter() - t0
    argv = ["--meta_path", "unused", "--model_name_or_path", base, "--seed", "1", "--device",
            str(device), "--vision_path", parts["vit"], "--llm_path", parts["llm"],
            "--mlp_path", parts["mlp"]]
    _, grafted, _ = common.build_model_and_tokenizer(parse_args("graft", argv), 2)
    r_graft = readout(grafted, ids, pv, mask)
    del grafted
    # the control: seed 1's fp32 weights with the three subtrees of the tree
    seed1 = common.build_serving_model(cfg, device=device, precision=Precision.fp32(), seed=1)
    weights = dict(seed1.state_dict())
    del seed1
    names = ("vision_model.", "language_model.", "mlp1.", "motion_mlp.")
    weights.update({k: v for k, v in state_dict_from_jax(tree, cfg).items()
                    if k.startswith(names)})
    control = common.build_serving_model(cfg, device=device, seed=1, weights=weights)
    del weights
    r_ctrl = readout(control, ids, pv, mask)
    del control
    torch.cuda.empty_cache()
    remove(src, base, *parts.values())
    if not torch.equal(r_graft, r_ctrl) or not torch.isfinite(r_graft).all():
        raise RuntimeError(f"14e: the grafted model's readout is "
                           f"{(r_graft - r_ctrl).abs().max().item()} from the control's")
    phase("ckpt", f"14e at {layers} layers per tower: tools.extract_vit, extract_mlp, "
          f"replace_llm on the fp32 tree's file in {tools_s:.1f} s; --vision_path / --llm_path "
          f"/ --mlp_path over the seed-1 model: readout bit-equal to seed 1's weights with the "
          f"tree's three subtrees (the score head and SlowFast stay seed 1's) [{smi}]")


def run_merge_tool(device, smi, work: str, ids, mask, px_u8, *, layers: int) -> dict:
    """Phase 14d at `layers` per tower: phase 13a's LoRA checkpoint
    (`lora_reference`) as a JAX tree on disk, `tools.merge_lora` on it, the
    result served without adapters (bf16): its readout bit-equal to 13a's
    in-memory merged control's (`merged_checkpoint`)."""
    from aigv_assessor_torch.cli.common import build_serving_model
    from aigv_assessor_torch.models.loading import (
        jax_tree, load_jax_params, save_jax_params, weights_from_jax)
    from aigv_assessor_torch.ops.preprocess import resize_normalize
    from aigv_assessor_torch.tools import merge_lora

    cfg = phase14_config(layers)
    ids = phase14_prompt(ids, cfg.img_context_token_id)
    ref, lcfg = lora_reference(cfg, device)
    merged = merged_checkpoint(ref, lcfg, device)
    pv = resize_normalize(px_u8, size=IMAGE, dtype=torch.bfloat16)
    src, dst = os.path.join(work, "lora.safetensors"), os.path.join(work, "merged.safetensors")
    t0 = time.perf_counter()
    save_jax_params(src, jax_tree(ref))
    del ref
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        merge_lora.main(["--params", src, "--out", dst])
    merge_s = time.perf_counter() - t0
    model = build_serving_model(merged[0], device=device, seed=0,
                                weights=weights_from_jax(load_jax_params(dst), merged[0]))
    r_tool = readout(model, ids, pv, mask)
    del model
    control = build_serving_model(merged[0], device=device, seed=0, weights=merged[1])
    del merged
    r_ctrl = readout(control, ids, pv, mask)
    del control
    torch.cuda.empty_cache()
    remove(src, dst)
    if not torch.equal(r_tool, r_ctrl) or not torch.isfinite(r_tool).all():
        raise RuntimeError(f"14d: the merge tool's checkpoint gives a readout "
                           f"{(r_tool - r_ctrl).abs().max().item()} from merge_lora_'s")
    phase("ckpt", f"14d at {layers} layers per tower: phase 13a's LoRA checkpoint (r = "
          f"{LORA_RANK}, lora_b ~N(0, {LORA_B_STD})) written as a JAX tree in {write_s:.1f} s, "
          f"tools.merge_lora on the card in {merge_s:.1f} s (read, merge, write); served "
          f"without adapters in bf16: readout bit-equal to merge_lora_'s in-memory control "
          f"[{smi}]")
    return dict(write_s=write_s, merge_s=merge_s)


def run_phase14(device, smi, ids, mask, px_u8, *, n_vit: int, n_llm: int) -> dict:
    """Phase 14: 14a-c at full depth, 14d-e at PHASE14_CUT layers per tower,
    every artifact under one temporary directory (its free space printed
    first) that is removed at the end."""
    import shutil

    t0 = time.perf_counter()
    work = tempfile.mkdtemp(prefix="aigv_phase14_")
    free = shutil.disk_usage(work)
    phase("ckpt", f"14 artifacts under {work}: {free.free / 1e9:.1f} GB free of "
          f"{free.total / 1e9:.1f} GB")
    try:
        out = dict(resize=run_resize(device, smi, ids, mask, n_vit=n_vit, n_llm=n_llm),
                   files=run_checkpoint_files(device, smi, work, ids, mask, px_u8,
                                              n_vit=n_vit, n_llm=n_llm),
                   merge=run_merge_tool(device, smi, work, ids, mask, px_u8,
                                        layers=PHASE14_CUT))
        run_grafts(device, smi, work, ids, mask, px_u8, layers=PHASE14_CUT)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    out["wall_s"] = time.perf_counter() - t0
    phase("ckpt", f"14 the phase's wall time {out['wall_s']:.1f} s (target {PHASE14_BUDGET_S} "
          f"s; 14d-e at {PHASE14_CUT} layers per tower), every artifact deleted [{smi}]")
    return out


# --------------------------------------------- 15: the other decoders --


# InternVL2-4B and InternVL2-1B: InternViT-300M-448px (the VisionConfig
# default, as phase 4's) beside the decoders of their published config.json
# files (microsoft/Phi-3-mini-128k-instruct, Qwen/Qwen2-0.5B-Instruct). The
# repository does not hold Phi-3's two 48-entry su factor tables: they stand
# in as ramps, short from 1.0 to 1.1 and long from 1.0 to 3.0. Every width is
# the published one.
PHI3_MINI_128K = {
    "architectures": ["Phi3ForCausalLM"], "vocab_size": 32064, "hidden_size": 3072,
    "intermediate_size": 8192, "num_hidden_layers": 32, "num_attention_heads": 32,
    "num_key_value_heads": 32, "hidden_act": "silu", "max_position_embeddings": 131072,
    "original_max_position_embeddings": 4096, "rms_norm_eps": 1e-5, "rope_theta": 10000.0,
    "rope_scaling": {"type": "su", "short_factor": np.linspace(1.0, 1.1, 48).tolist(),
                     "long_factor": np.linspace(1.0, 3.0, 48).tolist()},
    "tie_word_embeddings": False, "bos_token_id": 1, "eos_token_id": 32000,
    "pad_token_id": 32000}
QWEN2_05B = {
    "architectures": ["Qwen2ForCausalLM"], "vocab_size": 151936, "hidden_size": 896,
    "intermediate_size": 4864, "num_hidden_layers": 24, "num_attention_heads": 14,
    "num_key_value_heads": 2, "hidden_act": "silu", "max_position_embeddings": 32768,
    "rms_norm_eps": 1e-6, "rope_theta": 1000000.0, "tie_word_embeddings": True,
    "bos_token_id": 151643, "eos_token_id": 151645, "use_sliding_window": False}
# 15a, (B, hq, hkv, S, D, causal, kv_valid): Phi-3-mini's decoder at D = 96
# (scoring: 4 videos; training: 2), Qwen2-0.5B's 14 / 2 heads
P15_SHAPES = {"phi3": (4, 32, 32, 2113, 96, True, None),
              "phi3_train": (2, 32, 32, 2113, 96, True, None),
              "qwen2": (4, 14, 2, 2113, 64, True, None)}
# K2 on three tensors: Phi-3's row-major branch under int8 / int4 weights,
# (B, Sq, Skv, hq, hkv, D, causal, kv_valid, layout)
P15_ROWS = (4, 2113, 2113, 32, 32, 96, True, None, "bshd")
# K8, (B, hq, hkv, D, max_len, end, starts)
P15_DECODE = {"phi3": (4, 32, 32, 96, 2177, 2145, (0, 0, 0, 0)),
              "qwen2": (4, 14, 2, 64, 2177, 2145, (0, 3, 0, 40))}
P15_GEN_TOKENS = 16
P15_TRAIN_VIDEOS = 2
P15_CLI_CUT = 2  # layers per tower of 15g's checkpoint


@contextlib.contextmanager
def tally_heads(fa):
    """The fused-qkv kernels' launches inside the block by form and head
    shape, {"<bhsd | bsd | lse | bwd> <hq>/<hkv>/<D>": n}: each wrapper
    counts its kernel's launches, and one model runs it at two head shapes
    (its ViT's and its decoder's). A launch is tallied where it returned."""
    tally: dict = {}
    real_fwd, real_bwd = fa._launch_fwd, fa._launch_qkv_bwd

    def add(form, qkv, hq, hkv):
        key = f"{form} {hq}/{hkv}/{qkv.shape[-1]}"
        tally[key] = tally.get(key, 0) + 1

    def fwd(*args):  # (qkv, hq, hkv, causal, kv_valid, out_layout, with_lse)
        out = real_fwd(*args)
        add("lse" if args[6] else args[5], *args[:3])
        return out

    def bwd(*args):  # (qkv, out, dout, lse, delta, dqkv, hq, hkv, causal, kv_valid)
        real_bwd(*args)
        add("bwd", args[0], args[6], args[7])

    with mock.patch.object(fa, "_launch_fwd", fwd), mock.patch.object(fa, "_launch_qkv_bwd", bwd):
        yield tally


def check_separate_rows(fa, device, shape) -> dict:
    """K2's forward at a decoder's row-major shape ([B, S, H, D] views of one
    projection output): against its plain version, bit-equal to K1 on the
    same data, timed by CUDA graph replay beside its bound, the plain version
    and SDPA on head-major views of the same tensors."""
    b, s, _, hq, hkv, d, causal, kv_valid, _ = shape
    gen = torch.Generator(device=device).manual_seed(2)
    proj = torch.randn((b, s, (hq + 2 * hkv) * d), generator=gen, device=device).to(torch.bfloat16)
    q = proj[..., : hq * d].view(b, s, hq, d)
    k = proj[..., hq * d : (hq + hkv) * d].view(b, s, hkv, d)
    v = proj[..., (hq + hkv) * d :].view(b, s, hkv, d)
    kw = dict(causal=causal)
    got = fa.flash_attention(q, k, v, **kw)
    fused = fa.flash_attention_qkv(proj.view(b, s, hq + 2 * hkv, d).transpose(1, 2), hq, hkv,
                                   causal=causal, out_layout="bsd")
    torch.cuda.synchronize()
    want = fa.plain_flash_attention(q, k, v, **kw)
    if got.shape != q.shape or not torch.isfinite(got).all():
        raise RuntimeError(f"K2 at {shape}: output not finite or of shape {tuple(got.shape)}")
    torch.testing.assert_close(got.float(), want.float(), atol=TOL, rtol=TOL)
    err = (got.float() - want.float()).abs().max().item()
    if not torch.equal(got.reshape(fused.shape), fused):
        raise RuntimeError(f"K2 at {shape}: not bit-equal to K1 on the same data")
    ms = graph_ms([lambda: fa.flash_attention(q, k, v, **kw)] * 3, 10)
    plain_ms = time_ms(lambda: fa.plain_flash_attention(q, k, v, **kw), 3, warmup=1)
    qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
    lib_shape = (b, hq, hkv, s, d, causal, kv_valid)
    with torch.no_grad():
        lib_err = (sdpa(qh, kh, vh, lib_shape).transpose(1, 2).float()
                   - want.float()).abs().max().item()
        library_ms = graph_ms([lambda: sdpa(qh, kh, vh, lib_shape)] * 3, 10)
    flops, nbytes = separate_work(shape)["fwd"]
    bound, bound_by = bound_ms(flops, nbytes)
    text = f"bshd views of one projection, B={b} hq={hq} hkv={hkv} S={s} D={d} causal={causal}"
    phase("kernel", f"15a three-tensor attention (K2) {text}: max_abs_err {err:.3e} "
          f"(atol=rtol={TOL}), bit-equal to K1; by graph replay {ms:.4f} ms "
          f"({rate_text(flops, bound, ms)}, FLOPs of D = {d}), SDPA {library_ms:.4f} ms "
          f"({rate_text(flops, bound, library_ms)}; max_abs_err to plain {lib_err:.3e}); plain "
          f"{plain_ms:.4f} ms; bound {bound:.4f} ms ({bound_by})")
    return dict(shape=text, max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                library_max_abs_err=lib_err, bound_ms=bound, bound_by=bound_by,
                **rate(flops, bound, ms))


def p15_config(llm: dict, layers=None):
    """InternVL2-4B / -1B as `AssessorConfig.from_dict` reads its composite
    config.json: InternViT-300M-448px and the decoder `llm`, stage 2, the
    synthetic prompts' <IMG_CONTEXT> id; `layers` per tower where given."""
    from aigv_assessor_torch.core.config import AssessorConfig

    vision = {} if layers is None else {"num_hidden_layers": layers}
    llm = llm if layers is None else dict(llm, num_hidden_layers=layers)
    return AssessorConfig.from_dict({"vision_config": vision, "llm_config": llm}).replace(
        stage=2, img_context_token_id=CTX)


def p15_counters():
    from aigv_assessor_torch.ops import decode_attention as dec
    from aigv_assessor_torch.ops import flash_attention as fa
    from aigv_assessor_torch.ops import int8_matmul as wo
    from aigv_assessor_torch.ops import quant_fuse as qf

    return (fa.flash_attention_qkv, fa.flash_attention, qf.layernorm_quant, qf.gelu_quant,
            qf.quant_rows, qf.rmsnorm_quant, qf.silu_mul_quant, wo.int8_matmul, wo.int4_matmul,
            fa.flash_attention_qkv_lse, fa.flash_attention_qkv_bwd_kernel, dec.decode_attention,
            dec.cached_decode_attention)


def run_p15_slice(cfg, name: str, mode: str, device, chunks, ids_pn, mask_pn, ids, mask, px_u8,
                  smi, want: dict, readout_bf16=None) -> dict:
    """15b / 15f: one precision's stage-2 scoring through `score_chunks`,
    every count at 0 just before it: launches per forward against `want`
    (the other kernels 0), ms per chunk, peak; the readout of the kernel path
    against the same forward on every kernel's plain version and against a
    reference: an fp32 forward (bf16), the same int8 weights with fp32
    activations (W8A8), the bf16 model of the dequantized weights
    (int8 / int4), at phases 4-6's tolerances."""
    from aigv_assessor_torch.cli.score import build_serving_model, score_batch, score_chunks
    from aigv_assessor_torch.core.precision import COMPONENTS, Precision
    from aigv_assessor_torch.models.assessor import AIGVAssessor
    from aigv_assessor_torch.ops import flash_attention as fa
    from aigv_assessor_torch.ops import int8_matmul as wo
    from aigv_assessor_torch.ops import quant_fuse as qf
    from aigv_assessor_torch.ops.preprocess import resize_normalize

    flags = {"bf16": {}, "w8a8": dict(w8a8=True),
             "w8a8_fused": dict(w8a8=True, precision=Precision(fuse_quant=COMPONENTS,
                                                               quant_rows=COMPONENTS)),
             "int8": dict(int8=True), "int4": dict(int4=True)}[mode]
    t0 = time.perf_counter()
    model = build_serving_model(cfg, device=device, seed=0, **flags)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weights_gib = torch.cuda.memory_allocated(device) / 2**30
    scores = score_batch(model, ids, px_u8, mask)  # warm-up
    torch.cuda.synchronize()
    if tuple(scores.shape) != (BATCH, 1) or not torch.isfinite(scores).all():
        raise RuntimeError(f"{name} {mode}: scores {tuple(scores.shape)} not finite [{BATCH}, 1]")
    torch.cuda.reset_peak_memory_stats(device)
    counters = p15_counters()
    for c in counters:
        c.launches = 0
    wo.int8_matmul.form_launches = dict.fromkeys(wo.FORMS, 0)
    wo.int4_matmul.form_launches = dict.fromkeys(wo.FORMS, 0)
    with tally_heads(fa) as tally:
        t0 = time.perf_counter()
        rows = score_chunks(model, chunks, ids_pn, mask_pn, batch_size=BATCH)
        torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / len(chunks)
    peak_gib = torch.cuda.max_memory_allocated(device) / 2**30
    counts = {c.__name__: c.launches for c in counters}
    per_fwd = {k: v // len(chunks) for k, v in counts.items() if v}
    if per_fwd != want or any(v % len(chunks) for v in counts.values()):
        raise RuntimeError(f"{name} {mode}: launches per forward {per_fwd}, expected {want}")
    forms = {f"int{bits}": dict(getattr(wo, f"int{bits}_matmul").form_launches)
             for bits in (8, 4) if mode == f"int{bits}"}
    for label, f in forms.items():
        if f != dict(dict.fromkeys(wo.FORMS, 0), gemm=want[f"{label}_matmul"] * len(chunks)):
            raise RuntimeError(f"{name} {mode}: matmul forms {f}, expected the GEMM form only")
    arr = np.asarray(rows)
    if arr.shape != (len(chunks) * BATCH, 1) or not np.isfinite(arr).all():
        raise RuntimeError(f"{name} {mode}: score rows {arr.shape} not finite")

    swaps = ((fa, "flash_attention_qkv", fa.plain_attention_qkv),
             (fa, "flash_attention", fa.plain_flash_attention),
             (qf, "layernorm_quant", qf.plain_layernorm_quant),
             (qf, "gelu_quant", qf.plain_gelu_quant),
             (qf, "quant_rows", qf.plain_quant_rows),
             (qf, "rmsnorm_quant", qf.plain_rmsnorm_quant),
             (qf, "silu_mul_quant", qf.plain_silu_mul_quant),
             (wo, "int8_matmul", wo.plain_int8_matmul),
             (wo, "int4_matmul", wo.plain_int4_matmul))

    def plain_calls():
        stack = contextlib.ExitStack()
        for module, attr, plain in swaps:
            stack.enter_context(mock.patch.object(module, attr, plain))
        return stack

    cd = model.precision.compute_dtype
    if mode == "bf16":
        ref = copy.deepcopy(model).float()
        ref.precision = ref.language_model.precision = Precision.fp32()
        ref_dtype, ref_plain, ref_name = torch.float32, True, "fp32 forward"
    elif mode.startswith("w8a8"):
        with torch.device("meta"):
            ref = AIGVAssessor(cfg, dataclasses.replace(model.precision,
                                                        compute_dtype=torch.float32))
        ref.load_state_dict({k: v.float() if v.is_floating_point() else v
                             for k, v in model.state_dict().items()}, strict=True, assign=True)
        ref_dtype, ref_plain, ref_name = torch.float32, True, "fp32-activation W8A8 forward"
    else:
        bits = int(mode[3:])
        state = {}
        for key, t in model.state_dict().items():
            if key.endswith(".weight_scale"):
                continue
            if t.dtype == torch.int8:
                m = model.get_submodule(key[: -len(".weight")])
                t = (wo.dequantize_kernel(t, m.weight_scale) if bits == 8 else
                     wo.dequantize_kernel_int4(t, m.weight_scale, m.in_features))
                t = t.to(torch.bfloat16)
            state[key] = t
        with torch.device("meta"):
            ref = AIGVAssessor(cfg, Precision())
        ref.load_state_dict(state, strict=True, assign=True)
        del state
        ref_dtype, ref_plain, ref_name = torch.bfloat16, False, "bf16 model of the dequantized weights"
    ref.eval()
    with torch.inference_mode():
        pv = resize_normalize(px_u8, size=IMAGE, dtype=torch.float32)
        kernel_out = model(ids[:, 0], pv.to(cd), mask[:, 0])["readout"].float()
        launched = [c.launches for c in counters]
        with plain_calls():
            plain_out = model(ids[:, 0], pv.to(cd), mask[:, 0])["readout"].float()
        if [c.launches for c in counters] != launched:
            raise RuntimeError(f"{name} {mode}: the plain forward launched a kernel")
        with plain_calls() if ref_plain else contextlib.nullcontext():
            ref_out = ref(ids[:, 0], pv.to(ref_dtype), mask[:, 0])["readout"].float()
    del ref
    kp, kr, pr = (relative_l2(kernel_out, plain_out), relative_l2(kernel_out, ref_out),
                  relative_l2(plain_out, ref_out))
    if not torch.isfinite(kernel_out).all():
        raise RuntimeError(f"{name} {mode}: readout not finite")
    if mode in ("int8", "int4"):
        ok, tol_text = (kp <= WEIGHT_ONLY_READOUT_TOL and kr <= WEIGHT_ONLY_READOUT_TOL,
                        f"tol {WEIGHT_ONLY_READOUT_TOL} both")
    else:
        tol = READOUT_TOL if mode == "bf16" else W8A8_READOUT_TOL
        ok, tol_text = kp <= tol and kr <= REF_RATIO * pr, f"tol {tol}, {REF_RATIO}x"
    if not ok:
        raise RuntimeError(f"{name} {mode}: readout rel L2 kernel vs plain {kp}, kernel vs "
                           f"{ref_name} {kr}, plain vs it {pr} ({tol_text})")
    cos_text = ""
    if readout_bf16 is not None:
        a, bf = kernel_out.flatten(), readout_bf16.flatten()
        cosine = (a @ bf / (a.norm() * bf.norm())).item()
        floor = {"w8a8": W8A8_COSINE, "w8a8_fused": W8A8_COSINE, "int8": INT8_COSINE}.get(mode)
        if floor is not None and not cosine >= floor:
            raise RuntimeError(f"{name} {mode}: readout cosine to bf16 {cosine} below {floor}")
        cos_text = f", cosine to bf16 {cosine:.5f}" + (f" (tol {floor})" if floor else "")
    phase("slice", f"15 {name} {mode} stage-2 scoring, {len(chunks)} chunks x {BATCH} videos x "
          f"{FRAMES} frames {IMAGE}px, seq {ids.shape[-1]}: launches per forward {per_fwd} "
          f"(fused-qkv by form and heads hq/hkv/D over the run: {tally}"
          f"{f', matmul forms {forms}' if forms else ''}), {ms:.1f} ms/chunk, peak "
          f"{peak_gib:.2f} GiB allocated (weights {weights_gib:.2f} GiB), init {init_s:.1f} s; "
          f"readout rel L2 kernel vs plain {kp:.3e}, vs the {ref_name}: kernel {kr:.3e}, plain "
          f"{pr:.3e} ({tol_text}){cos_text}; scores {np.round(arr[:, 0], 4).tolist()} [{smi}]")
    del model, pv
    gc.collect()
    torch.cuda.empty_cache()
    return dict(counts=counts, per_forward=per_fwd, tally=tally, forms=forms, ms=ms,
                peak_gib=peak_gib, weights_gib=weights_gib, readout=kernel_out)


def run_p15_cli(device, smi) -> dict:
    """15g: `cli.score.main` on phase 10's videos from a directory holding
    InternVL2-4B's composite config.json (the Phi-3 decoder, P15_CLI_CUT
    layers per tower), the test tokenizer and the fp32 JAX tree of the model
    drawn from seed 0 (`save_jax_params`), against the same call on a
    directory without weights, which draws that model in bf16: the scores
    bit-equal (one fp32 draw, rounded once either way)."""
    from aigv_assessor_torch.cli import common, score
    from aigv_assessor_torch.core.config import Phi3Config
    from aigv_assessor_torch.core.precision import Precision
    from aigv_assessor_torch.data.tokenizer import build_test_tokenizer
    from aigv_assessor_torch.models.loading import jax_tree, save_jax_params
    from aigv_assessor_torch.ops import flash_attention as fa
    from aigv_assessor_torch.tools.make_synthetic_ckpt import reference_config_dict

    tok = build_test_tokenizer()
    cfg = p15_config(PHI3_MINI_128K, P15_CLI_CUT).replace(
        img_context_token_id=int(tok.img_context_token_id))
    config = reference_config_dict(cfg)
    config["llm_config"] = dict(PHI3_MINI_128K, num_hidden_layers=P15_CLI_CUT)
    questions = ["How would you rate the static quality of this video?",
                 "How would you rate the temporal smoothness of this video?"]
    rows, tallies = {}, {}
    with tempfile.TemporaryDirectory() as work:
        dirs = {label: os.path.join(work, label) for label in ("params", "seed")}
        for d in dirs.values():
            os.makedirs(d)
            with open(os.path.join(d, "config.json"), "w") as f:
                json.dump(config, f)
            tok._tk.save(os.path.join(d, "tokenizer.json"))
        read = common.config_from_args(common.serving_args(dirs["seed"]), 2)
        if not isinstance(read.llm, Phi3Config) or read.llm.head_dim != 96:
            raise RuntimeError(f"15g: config.json read as {type(read.llm).__name__}")
        model = common.build_serving_model(cfg, device=device, precision=Precision.fp32(), seed=0)
        t0 = time.perf_counter()
        save_jax_params(os.path.join(dirs["params"], "params.safetensors"), jax_tree(model))
        write_s = time.perf_counter() - t0
        del model
        torch.cuda.empty_cache()
        videos = os.path.join(work, "videos")
        os.makedirs(videos)
        write_cli_videos(videos)
        build = common.build_serving_model
        with mock.patch.object(common, "build_serving_model",
                               lambda *a, **kw: opened_score_head(build(*a, **kw))):
            for label, d in dirs.items():
                argv = ["--videos", videos, "--model_name_or_path", d, "--batch_size",
                        str(BATCH), "--num_segments", str(FRAMES), "--device", str(device),
                        "--out", os.path.join(work, f"{label}.csv"),
                        *[a for q in questions for a in ("--question", q)]]
                with tally_heads(fa) as tally, contextlib.redirect_stdout(io.StringIO()):
                    rows[label] = [r[1:] for r in score.main(argv)]
                tallies[label] = tally
    if rows["params"] != rows["seed"] or not np.any(np.asarray(rows["seed"], dtype=float)):
        raise RuntimeError(f"15g: scores from params.safetensors {rows['params']} are not the "
                           f"seed's {rows['seed']}")
    if not tallies["params"].get("bhsd 32/32/96"):
        raise RuntimeError(f"15g: the CLI's run launched no Phi-3 attention: {tallies['params']}")
    phase("cli", f"15g cli.score.main --model_name_or_path: InternVL2-4B's config.json (Phi-3, "
          f"{P15_CLI_CUT} layers per tower) and its fp32 JAX tree as params.safetensors (written "
          f"in {write_s:.1f} s): {len(rows['seed'])} videos x {len(questions)} questions on the "
          f"shared prefix, scores bit-equal to the same call drawing the model from seed 0; "
          f"fused-qkv launches by form and heads {tallies['params']}; scores of the first "
          f"video {rows['seed'][0]} [{smi}]")
    return dict(tally=tallies["params"], rows=len(rows["seed"]))


def run_phase15(device, smi, videos) -> dict:
    """Phase 15: InternVL2-4B (Phi-3-mini) and InternVL2-1B (Qwen2-0.5B)."""
    from aigv_assessor_torch.ops import decode_attention as dec
    from aigv_assessor_torch.ops import flash_attention as fa
    from aigv_assessor_torch.ops.attention import two_part_cached_attention

    t_start = time.perf_counter()
    out = {}
    # 15a: the kernels alone at the new head shapes
    out["fwd"] = check_attention(fa, device, P15_SHAPES)
    out["train"] = check_attention_training(fa, device, {"phi3_train": P15_SHAPES["phi3_train"]})
    out["rows"] = check_separate_rows(fa, device, P15_ROWS)
    out["decode"] = check_decode_attention(dec, two_part_cached_attention, device, P15_DECODE,
                                           timed_shapes=tuple(P15_DECODE))
    t_a = time.perf_counter() - t_start

    cfg4, cfg1 = p15_config(PHI3_MINI_128K), p15_config(QWEN2_05B)
    rng = np.random.default_rng(15)
    n_ctx = FRAMES * cfg4.num_image_token + 1
    seq = n_ctx + TEXT
    ids_pn = rng.integers(10, cfg4.llm.vocab_size, (1, seq))  # within both vocabularies
    ids_pn[:, 1 : 1 + n_ctx] = CTX
    mask_pn = np.ones((1, seq), bool)
    chunks = [list(videos[i : i + BATCH]) for i in range(0, len(videos), BATCH)]
    ids = torch.as_tensor(np.tile(ids_pn[None], (BATCH, 1, 1)), device=device)
    mask = torch.as_tensor(np.tile(mask_pn[None], (BATCH, 1, 1)), device=device)
    px_u8 = torch.as_tensor(videos[:BATCH], device=device)
    n_vit = cfg4.vision.num_hidden_layers
    slice_args = (device, chunks, ids_pn, mask_pn, ids, mask, px_u8, smi)

    def want(n_llm, mode, llm_projections):
        vit_w8a8 = dict(layernorm_quant=2 * n_vit, gelu_quant=n_vit, quant_rows=n_vit)
        return {"bf16": dict(flash_attention_qkv=n_vit + n_llm),
                "w8a8": dict(flash_attention_qkv=n_vit + n_llm, **vit_w8a8),
                "w8a8_fused": dict(flash_attention_qkv=n_vit + n_llm, **vit_w8a8,
                                   rmsnorm_quant=2 * n_llm, silu_mul_quant=n_llm),
                "int8": dict(flash_attention_qkv=n_vit, flash_attention=n_llm,
                             int8_matmul=llm_projections * n_llm),
                "int4": dict(flash_attention_qkv=n_vit, flash_attention=n_llm,
                             int4_matmul=llm_projections * n_llm)}[mode]

    # 15b: InternVL2-4B scoring in every precision
    t0 = time.perf_counter()
    n4 = cfg4.llm.num_hidden_layers
    out["4b"] = {}
    for mode in ("bf16", "w8a8", "w8a8_fused", "int8", "int4"):
        bf16 = out["4b"].get("bf16", {}).get("readout")
        out["4b"][mode] = run_p15_slice(cfg4, "InternVL2-4B", mode, *slice_args,
                                        want=want(n4, mode, 4), readout_bf16=bf16)
    t_b = time.perf_counter() - t0
    # 15c: greedy generation, bf16; 15d: the shared prefix
    t0 = time.perf_counter()
    out["gen4"] = run_generation(cfg4, device, ids[:, 0], px_u8, smi, label="bf16", n_llm=n4,
                                 n_vit=n_vit, name="InternVL2-4B", gen_tokens=P15_GEN_TOKENS)
    out["gen4"].pop("logits")
    run_shared_prefix(cfg4, device, videos, rng, smi, n_vit=n_vit, n_llm=n4,
                      name="InternVL2-4B")
    t_cd = time.perf_counter() - t0
    # 15e: stage-2 LoRA training
    t0 = time.perf_counter()
    out["train_tally"] = {}
    tv = P15_TRAIN_VIDEOS
    out["train4"] = run_train_slice(cfg4, device, ids[:tv], mask[:tv], px_u8[:tv], rng,
                                    n_vit + n4, smi, name="InternVL2-4B",
                                    tally=out["train_tally"])
    gc.collect()
    torch.cuda.empty_cache()
    t_e = time.perf_counter() - t0
    # 15f: InternVL2-1B, bf16 and W8A8 scoring, generation through the tied head
    t0 = time.perf_counter()
    n1 = cfg1.llm.num_hidden_layers
    out["1b"] = {}
    for mode in ("bf16", "w8a8"):
        bf16 = out["1b"].get("bf16", {}).get("readout")
        out["1b"][mode] = run_p15_slice(cfg1, "InternVL2-1B", mode, *slice_args,
                                        want=want(n1, mode, 5), readout_bf16=bf16)
    out["gen1"] = run_generation(cfg1, device, ids[:, 0], px_u8, smi, label="bf16", n_llm=n1,
                                 n_vit=n_vit, name="InternVL2-1B", gen_tokens=P15_GEN_TOKENS)
    out["gen1"].pop("logits")
    t_f = time.perf_counter() - t0
    # 15g: the score CLI from a Phi-3 checkpoint directory
    t0 = time.perf_counter()
    out["cli"] = run_p15_cli(device, smi)
    t_g = time.perf_counter() - t0
    out["wall_s"] = time.perf_counter() - t_start
    phase("p15", f"15 wall time {out['wall_s']:.1f} s: 15a kernels {t_a:.1f} s, 15b 4B scoring "
          f"{t_b:.1f} s, 15c-d generation and shared prefix {t_cd:.1f} s, 15e training "
          f"{t_e:.1f} s, 15f 1B {t_f:.1f} s, 15g CLI {t_g:.1f} s [{smi}]")
    return out


# --------------------------------------------- more than one card (16) --

P16_VIDEOS, P16_BATCH = 6, 2  # 3 optimizer steps
P16_CHILD = "--p16-child"  # the argument of phase 16a's rank under torchrun
P16_CHILD_TIMEOUT_S = 400


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def p16_meta(folder: str, meta: str, n: int) -> str:
    """A copy of `meta` whose annotation keeps its first n videos."""
    with open(meta) as f:
        spec = json.load(f)
    (key, entry), = spec.items()
    with open(entry["annotation"]) as f:
        rows = f.readlines()[:n]
    ann = os.path.join(folder, "p16.jsonl")
    with open(ann, "w") as f:
        f.writelines(rows)
    out = os.path.join(folder, "meta_p16.json")
    with open(out, "w") as f:
        json.dump({key: dict(entry, annotation=ann)}, f)
    return out


def p16_train(argv, device) -> dict:
    """`cli/stage2_train.main(argv)` with the score head opened -> its
    launches, peak GiB, whether the trainer wrapped the model, the group."""
    import torch.distributed as dist

    from aigv_assessor_torch.cli import stage2_train
    from aigv_assessor_torch.ops import flash_attention as fa
    from aigv_assessor_torch.parallel.sharding import is_sharded

    build = stage2_train.build_training_model
    counters = training_counters(fa)
    for c in counters:
        c.launches = 0
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    with mock.patch.object(stage2_train, "build_training_model",
                           lambda *a, **kw: opened_score_head(build(*a, **kw))):
        trainer = stage2_train.main(argv)
    torch.cuda.synchronize()
    out = dict(counts={c.__name__: c.launches for c in counters},
               peak_gib=torch.cuda.max_memory_allocated(device) / 2**30,
               wall_s=time.perf_counter() - t0, sharded=is_sharded(trainer.model),
               world=dist.get_world_size() if dist.is_initialized() else 1,
               backend=dist.get_backend() if dist.is_initialized() else None)
    if out["sharded"]:
        p = next(p for n, p in trainer.model.named_parameters() if n in trainer.trainable)
        out["placements"] = str(p.placements)
        out["kinds"] = sorted({str(p.dtype) for p in trainer.model.parameters()})
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    return out


def p16_child(out_json: str, argv) -> int:
    """Phase 16a's rank, started by `torch.distributed.run`: the stage-2
    training CLI under the process group the launcher describes."""
    import torch.distributed as dist

    device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    torch.cuda.set_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = p16_train(argv, device)
    if not dist.is_initialized() or dist.get_rank() == 0:
        with open(out_json, "w") as f:
            json.dump(out, f)
    if dist.is_initialized():
        dist.destroy_process_group()
    return 0


def run_phase16(device, smi, ids, mask, px_u8, *, n_vit: int, n_llm: int) -> dict:
    """Phase 16: the multi-card layer on one card at world 1 over NCCL.
    (a) `cli/stage2_train.main` at 2B unwrapped in this process and through
    `torch.distributed.run --nproc_per_node 1 --mesh_fsdp 1` (FSDP2): the
    losses bit-equal, launches, ms per step, peak GiB. (b)
    `models/loading.shard_for_inference` of the 2B bf16 model in a group of
    one built here: one `score_perspectives` chunk against the unwrapped
    model's."""
    import torch.distributed as dist

    from aigv_assessor_torch.cli.score import build_serving_model
    from aigv_assessor_torch.core.config import LLM_2B, AssessorConfig
    from aigv_assessor_torch.models.loading import shard_for_inference
    from aigv_assessor_torch.ops import flash_attention as fa
    from aigv_assessor_torch.ops import quant_fuse as qf
    from aigv_assessor_torch.ops.preprocess import resize_normalize
    from aigv_assessor_torch.utils.profiling import StepTimer

    t_start = time.perf_counter()
    layers = n_vit + n_llm
    steps = P16_VIDEOS // P16_BATCH
    runs = {}
    with tempfile.TemporaryDirectory() as d:
        meta = p16_meta(d, write_eval_metas(d)[0], P16_VIDEOS)

        def argv(label):
            return ["--meta_path", meta, "--model_scale", "2b", "--num_segments", str(FRAMES),
                    "--do_train", "True", "--num_train_epochs", "1",
                    "--per_device_train_batch_size", str(P16_BATCH),
                    "--evaluation_strategy", "no", "--use_backbone_lora", str(LORA_RANK),
                    "--use_llm_lora", str(LORA_RANK), "--output_dir", os.path.join(d, label),
                    "--device", "cuda"]

        if dist.is_initialized():
            raise RuntimeError("16a: a process group exists before the unwrapped run")
        runs["unwrapped"] = p16_train(argv("unwrapped"), device)
        child_json = os.path.join(d, "child.json")
        env = dict(os.environ, PYTHONPATH=os.path.dirname(os.path.abspath(__file__)))
        for key in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
            env.pop(key, None)
        cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", "1",
               "--master_addr", "127.0.0.1", "--master_port", str(free_port()),
               os.path.abspath(__file__), P16_CHILD, child_json,
               *argv("fsdp"), "--mesh_fsdp", "1"]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, env=env, capture_output=True, text=True,
                              timeout=P16_CHILD_TIMEOUT_S)
        child_s = time.perf_counter() - t0
        if proc.returncode != 0 or not os.path.exists(child_json):
            raise RuntimeError(f"16a: torch.distributed.run rc {proc.returncode}:\n"
                               f"{proc.stdout[-3000:]}\n{proc.stderr[-6000:]}")
        with open(child_json) as f:
            runs["fsdp"] = json.load(f)
        runs["fsdp"]["launcher_s"] = child_s
        for label, r in runs.items():
            with open(os.path.join(d, label, "train_log.jsonl")) as f:
                log = [json.loads(line) for line in f if "loss" in line]
            r["losses"] = [rec["loss"] for rec in log]
            times = [rec["time"] for rec in log]
            r["step_ms"] = [(b - a) * 1e3 for a, b in zip(times[1:], times[2:])]
            if len(r["losses"]) != steps or not np.isfinite(r["losses"]).all():
                raise RuntimeError(f"16a {label}: losses {r['losses']}, expected {steps}")
            per_mb = {"flash_attention_qkv_lse": 2 * layers,
                      "flash_attention_qkv_bwd_kernel": layers}
            want = {k: 0 for k in r["counts"]}
            want.update({k: steps * v for k, v in per_mb.items()})
            if r["counts"] != want:
                raise RuntimeError(f"16a {label}: launches {r['counts']}, expected {want}")
            for path in ("lora_weights.safetensors", f"checkpoints/{steps}/default/_METADATA"):
                if not os.path.exists(os.path.join(d, label, path)):
                    raise RuntimeError(f"16a {label}: no {path}")
        un, fs = runs["unwrapped"], runs["fsdp"]
        if un["sharded"] or not fs["sharded"] or fs["world"] != 1 or fs["backend"] != "nccl":
            raise RuntimeError(f"16a: unwrapped sharded={un['sharded']}; torchrun sharded="
                               f"{fs['sharded']} world {fs['world']} backend {fs['backend']}")
        diffs = [abs(a - b) / max(abs(a), 1e-30) for a, b in zip(un["losses"], fs["losses"])]
        if max(diffs) > 1e-5:
            raise RuntimeError(f"16a: losses unwrapped {un['losses']} and FSDP2 "
                               f"{fs['losses']} differ by {max(diffs):.3e} relative (max 1e-5)")
    bit_equal = un["losses"] == fs["losses"]
    phase("dist", f"16a cli.stage2_train.main --model_scale 2b LoRA r={LORA_RANK}, {FRAMES} "
          f"frames, batch {P16_BATCH}, {steps} steps: unwrapped losses {un['losses']}; "
          f"torch.distributed.run --nproc_per_node 1 --mesh_fsdp 1 (NCCL, world 1, FSDP2, "
          f"placements {fs.get('placements')}, parameter dtypes {fs.get('kinds')}) losses "
          f"{fs['losses']}: {'bit-equal' if bit_equal else f'max rel diff {max(diffs):.3e}'}; "
          f"ms/step (steps 2-3) unwrapped {np.round(un['step_ms'], 1).tolist()}, FSDP2 "
          f"{np.round(fs['step_ms'], 1).tolist()}; peak {un['peak_gib']:.2f} / "
          f"{fs['peak_gib']:.2f} GiB; launches under FSDP2 {fs['counts']}; the launcher's "
          f"call {fs['launcher_s']:.1f} s [{smi}]")

    # 16b: sharded scoring in a group of one, no launcher, in bf16 and W8A8
    cfg = AssessorConfig(llm=LLM_2B, stage=2).replace(img_context_token_id=CTX)
    counters = (fa.flash_attention_qkv, qf.layernorm_quant, qf.gelu_quant, qf.quant_rows)
    per_forward = {"bf16": {"flash_attention_qkv": layers},
                   "w8a8": {"flash_attention_qkv": layers, "layernorm_quant": 2 * n_vit,
                            "gelu_quant": n_vit, "quant_rows": n_vit}}

    def chunk(m, pv):
        timer = StepTimer()  # synchronizes the card before each reading
        with torch.no_grad():  # FSDP2 cannot run under inference_mode
            m.score_perspectives(ids, pv, mask)  # warm-up
            for c in counters:
                c.launches = 0
            torch.cuda.reset_peak_memory_stats(device)
            with timer.step():
                out = m.score_perspectives(ids, pv, mask).float()
        return dict(scores=out, ms=timer.times[0] * 1e3,
                    counts={c.__name__: c.launches for c in counters},
                    peak_gib=torch.cuda.max_memory_allocated(device) / 2**30)

    scored = {}
    for mode in ("bf16", "w8a8"):
        model = opened_score_head(build_serving_model(cfg, device=device, seed=0,
                                                      w8a8=mode == "w8a8"))
        pv = resize_normalize(px_u8, size=IMAGE, dtype=model.precision.compute_dtype)
        plain = chunk(model, pv)
        dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{free_port()}",
                                world_size=1, rank=0)
        try:
            _, model = shard_for_inference(model)
            sharded = chunk(model, pv)
        finally:
            dist.destroy_process_group()
        del model
        gc.collect()
        torch.cuda.empty_cache()
        err = float((sharded["scores"] - plain["scores"]).abs().max())
        scale = float(plain["scores"].abs().max())
        want = {c.__name__: per_forward[mode].get(c.__name__, 0) for c in counters}
        if (sharded["counts"] != want or plain["counts"] != want or not scale > 0
                or not torch.isfinite(sharded["scores"]).all() or err > 1e-5 * scale):
            raise RuntimeError(f"16b {mode}: scores {sharded['scores'].tolist()} against "
                               f"{plain['scores'].tolist()} (max abs diff {err:.3e}), launches "
                               f"{sharded['counts']} / {plain['counts']}, expected {want}")
        phase("dist", f"16b shard_for_inference (FSDP2, NCCL, world 1) of the {mode} "
              f"InternVL2-2B, one score_perspectives chunk of {BATCH} videos: scores "
              f"{np.round(sharded['scores'][:, 0].tolist(), 4).tolist()}, max abs diff to the "
              f"unwrapped model {err:.3e}{' (bit-equal)' if err == 0 else ''}; launches "
              f"{sharded['counts']}; {sharded['ms']:.1f} ms against {plain['ms']:.1f} "
              f"unwrapped; peak {sharded['peak_gib']:.2f} / {plain['peak_gib']:.2f} GiB [{smi}]")
        scored[mode] = dict(counts=sharded["counts"], ms=sharded["ms"], plain_ms=plain["ms"],
                            max_abs_err=err)
    phase("dist", f"16 phase 16 {time.perf_counter() - t_start:.1f} s [{smi}]")
    return dict(train=runs, score=scored)


# --------------------------------------------------------------- phase 17 --

P17_TENSOR = (2, 4)  # tensor-axis sizes whose shards phase 17 builds
P17_VIT_FRAMES = 8  # one video's frames through one ViT layer (1025 tokens, padded to 1032)
P17_ROWS = (4, 2113)  # a scoring chunk's prompts through one decoder layer
P17_TRAIN_ROWS = (2, 2113)  # the decoder rows of a stage-2 micro-batch of 2 videos
P17_ITERS = 10
P17_WEIGHT_STD = 0.02
# 17a's limits, relative L2, set between the bf16 readings and the
# controls (PERF.md, phase 17): a module's shards summed against the whole
# module (read 2.8e-3-3.9e-3 at tensor 2 and 4; the sum without shard 0
# 0.34-0.71), and one shard's K1 against the plain attention at its local
# heads (read 2.5e-3-2.9e-3; the plain output with its heads rolled
# 1.19-1.43)
P17_MODULE_TOL = 1.5e-2
P17_KERNEL_TOL = 1e-2


def p17_layers(device, lora: bool):
    """One InternViT-300M layer and one InternLM2-1.8B decoder layer (the
    2B's full widths), bf16 on the card, weights drawn from seed 0 (every
    projection, bias and adapter from N(0, P17_WEIGHT_STD); norms and
    LayerScale as built); with `lora`, rank-LORA_RANK adapters with dropout
    0.05, the only parameters that train."""
    from aigv_assessor_torch.core.config import LLM_2B, AssessorConfig, LoRAConfig
    from aigv_assessor_torch.models.internlm2 import InternLM2DecoderLayer
    from aigv_assessor_torch.models.vit import InternVisionEncoderLayer

    cfg = AssessorConfig(llm=LLM_2B, stage=2)
    lcfg = LoRAConfig(r=LORA_RANK, alpha=2 * LORA_RANK, dropout=0.05) if lora else None
    gen = torch.Generator().manual_seed(0)
    layers = []
    for layer in (InternVisionEncoderLayer(cfg.vision, lora=lcfg),
                  InternLM2DecoderLayer(cfg.llm, lora=lcfg)):
        with torch.no_grad():
            for name, p in layer.named_parameters():
                if "norm" not in name and not name.startswith("ls"):
                    p.copy_(torch.randn(p.shape, generator=gen) * P17_WEIGHT_STD)
                p.requires_grad_(name.endswith(("lora_a", "lora_b")))
        layers.append(layer.to(device, torch.bfloat16))
    return cfg, layers


def p17_rope(llm_cfg, rope_len: int, device):
    """The decoder's cos / sin tables of `rope_len` rows, as
    `InternLM2ForCausalLM` builds them."""
    from aigv_assessor_torch.ops.rope import rope_cos_sin

    rs = llm_cfg.rope_scaling
    return rope_cos_sin(rope_len, llm_cfg.head_dim, base=llm_cfg.rope_theta,
                        scaling_type=rs.type if rs else None,
                        scaling_factor=rs.factor if rs else 1.0,
                        max_position_embeddings=llm_cfg.max_position_embeddings, device=device)


def p17_shards(module, t: int) -> list:
    """Each of `t` ranks' group-less shard of `module` (`split_`)."""
    from aigv_assessor_torch.parallel.tensor import TensorSplit

    out = []
    for r in range(t):
        shard = copy.deepcopy(module)
        shard.split_(TensorSplit(t, r))
        out.append(shard)
    return out


def p17_sum(whole, shards, *args):
    """The shards' partial outputs summed on the card, the row-parallel
    bias added once (`sum_partials`): the whole module's output. `whole`
    alone with no shards."""
    from aigv_assessor_torch.parallel.tensor import sum_partials

    def first(out):
        return out[0] if isinstance(out, tuple) else out

    if shards is None:
        return first(whole(*args))
    return sum_partials(whole, [first(s(*args)) for s in shards])


def p17_partial(shard, *args):
    """One group-less shard's output: its partial sum before the bias."""
    out = shard(*args)
    return out[0] if isinstance(out, tuple) else out


@contextlib.contextmanager
def p17_capture(fa):
    """The fused-qkv forward's launches inside the block, each as (its
    arguments, its output), for `p17_kernel_vs_plain`."""
    calls: list = []
    real = fa._launch_fwd

    def fwd(*args):
        out = real(*args)
        calls.append((args, out))
        return out

    with mock.patch.object(fa, "_launch_fwd", fwd):
        yield calls


def p17_kernel_vs_plain(fa, calls) -> list:
    """Each captured K1 launch against `plain_attention_qkv` on the same
    qkv at the same (local) heads: rel L2, and as the control the rel L2
    of the plain output with its heads rolled by one, which a kernel that
    swapped or lost heads would show."""
    res = []
    for (qkv, hq, hkv, causal, kv_valid, layout, with_lse), (o, _) in calls:
        p = fa.plain_attention_qkv(qkv, hq, hkv, causal=causal, kv_valid=kv_valid,
                                   out_layout=layout).float()
        head = 1 if layout == "bhsd" else 2
        rolled = p.unflatten(-1, (hq, -1)).roll(1, head).flatten(-2) if layout == "bsd" \
            else p.roll(1, head)
        res.append(dict(shape=f"{layout} {hq}/{hkv}/{qkv.shape[-1]}",
                        rel_l2=relative_l2(o.float(), p), rolled=relative_l2(rolled, p)))
    return res


def p17_vit(layer, attns, mlps, x, kv_valid):
    """`InternVisionEncoderLayer.forward` (bf16, drop path 0) with its
    attention and MLP as the sums of shards."""
    a = p17_sum(layer.attn, attns, layer.norm1(x), kv_valid)
    x = x + a * layer.ls1.to(a.dtype)
    m = p17_sum(layer.mlp, mlps, layer.norm2(x))
    return x + m * layer.ls2.to(m.dtype)


def p17_llm(layer, attns, mlps, x, cos, sin, pos):
    """`InternLM2DecoderLayer.forward` (no cache) with its attention and MLP
    as the sums of shards."""
    x = x + p17_sum(layer.attention, attns, layer.attention_norm(x), cos, sin, pos)
    return x + p17_sum(layer.feed_forward, mlps, layer.ffn_norm(x))


def p17_require(counts: dict, label: str) -> None:
    if not counts or min(counts.values()) <= 0:
        raise RuntimeError(f"17 {label}: a kernel of the path did not launch: {counts}")


def run_phase17(device, smi) -> dict:
    """Phase 17: the `tensor` mesh axis at the 2B's full widths, each rank's
    shard built group-less (`parallel/tensor.py`) and run on the one card,
    the partial outputs summed here. (a) one ViT layer and one decoder
    layer forward, bf16, for tensor 2 and 4, against the whole layer; (b)
    the same layers with adapters in a stage-2 step, forward and backward,
    the shards' adapter and input gradients (gathered into the unsplit
    layout) against the whole layer's; (c) one decode step of the decoder's
    attention on per-rank caches cut from a full-width prefill's."""
    from aigv_assessor_torch.models.lora import set_generator
    from aigv_assessor_torch.ops import decode_attention as dec
    from aigv_assessor_torch.ops import flash_attention as fa
    from aigv_assessor_torch.parallel.tensor import split_leaves

    t_start = time.perf_counter()
    out: dict = {"a": {}, "b": {}, "c": {}}
    cfg, (vit, llm) = p17_layers(device, lora=False)
    vit.eval()
    llm.eval()
    gen = torch.Generator(device=device).manual_seed(17)
    n_tok = cfg.vision.num_patches + 1
    x_vit = torch.randn((P17_VIT_FRAMES, n_tok + (-n_tok) % 8, cfg.vision.hidden_size),
                        generator=gen, device=device).to(torch.bfloat16)
    b, s = P17_ROWS
    x_llm = torch.randn((b, s, cfg.llm.hidden_size), generator=gen,
                        device=device).to(torch.bfloat16)
    pos = torch.arange(s, device=device).expand(b, s)
    cos, sin = p17_rope(cfg.llm, s, device)
    counters = (fa.flash_attention_qkv, fa.flash_attention_qkv_lse,
                fa.flash_attention_qkv_bwd_kernel,
                dec.cached_decode_attention)

    def reset():
        for c in counters:
            c.launches = 0

    def counts():
        return {c.__name__: c.launches for c in counters if c.launches}

    # 17a: forward, module by module: the shards' sums (before the residual)
    # against the whole modules', and each shard's K1 against the plain
    # attention at its local heads on the kernel's own input
    with torch.no_grad():
        h1, h_llm = vit.norm1(x_vit), llm.attention_norm(x_llm)
        h2 = vit.norm2(x_vit + vit.attn(h1, n_tok) * vit.ls1)
        h2_llm = llm.ffn_norm(x_llm)
    args = {"vit.attn": (h1, n_tok), "vit.mlp": (h2,), "llm.attention": (h_llm, cos, sin, pos),
            "llm.feed_forward": (h2_llm,)}
    with torch.no_grad():
        wholes = {"vit.attn": vit.attn, "vit.mlp": vit.mlp, "llm.attention": llm.attention,
                  "llm.feed_forward": llm.feed_forward}
        want = {k: p17_sum(m, None, *args[k]) for k, m in wholes.items()}
        for t in P17_TENSOR:
            shards = {"vit.attn": p17_shards(vit.attn, t), "vit.mlp": p17_shards(vit.mlp, t),
                      "llm.attention": p17_shards(llm.attention, t),
                      "llm.feed_forward": p17_shards(llm.feed_forward, t)}
            reset()
            with tally_heads(fa) as tally, p17_capture(fa) as calls:
                got = {k: p17_sum(wholes[k], shards[k], *args[k]) for k in wholes}
                torch.cuda.synchronize()
            launched = counts()
            p17_require(launched, f"a tensor {t}")
            hv, hl = cfg.vision.num_attention_heads // t, cfg.llm.num_attention_heads // t
            kv = cfg.llm.num_key_value_heads // t
            want_tally = {f"bhsd {hv}/{hv}/{cfg.vision.hidden_size // cfg.vision.num_attention_heads}": t,
                          f"bhsd {hl}/{kv}/{cfg.llm.head_dim}": t}
            errs = {k: relative_l2(got[k].float(), want[k].float()) for k in wholes}
            # the control: the sum without shard 0's partial must miss
            drop = {k: relative_l2(got[k].float() - p17_partial(shards[k][0], *args[k]).float(),
                                   want[k].float()) for k in wholes}
            k1 = p17_kernel_vs_plain(fa, calls)
            bad = [k for k in wholes if not errs[k] <= P17_MODULE_TOL < drop[k]]
            bad += [c["shape"] for c in k1 if not c["rel_l2"] <= P17_KERNEL_TOL < c["rolled"]]
            if dict(tally) != want_tally or bad:
                raise RuntimeError(f"17a tensor {t}: launches by head shape {dict(tally)}, "
                                   f"expected {want_tally}; failed {bad}: module sums rel L2 "
                                   f"{errs} (max {P17_MODULE_TOL}), without shard 0 {drop}; "
                                   f"K1 vs plain {k1} (max {P17_KERNEL_TOL})")
            whole_ms = {k: time_ms(lambda k=k: p17_sum(wholes[k], None, *args[k]), P17_ITERS)
                        for k in wholes}
            shard_ms = {k: [time_ms(lambda m=m, k=k: m(*args[k]), P17_ITERS) for m in shards[k]]
                        for k in wholes}
            out["a"][t] = dict(tally=dict(tally), counts=launched, rel_l2=errs, dropped=drop,
                               k1=k1, shard_ms=shard_ms, whole_ms=whole_ms)
            phase("tensor", f"17a tensor {t}, 2B widths, bf16, one ViT layer's modules "
                  f"({P17_VIT_FRAMES} frames x {x_vit.shape[1]} rows) and one decoder layer's "
                  f"({b} x {s}): the shards' sums against the whole module rel L2 "
                  + ", ".join(f"{k} {errs[k]:.3e} (without shard 0 {drop[k]:.3e})" for k in wholes)
                  + f" (max {P17_MODULE_TOL}); each shard's K1 against the plain attention at "
                  f"its heads rel L2 " + ", ".join(f"{c['shape']} {c['rel_l2']:.3e} (heads rolled "
                                                     f"{c['rolled']:.3e})" for c in k1)
                  + f" (max {P17_KERNEL_TOL}); K1 launches by head shape {dict(tally)}; ms per "
                  f"shard against the whole module: "
                  + ", ".join(f"{k} {np.round(shard_ms[k], 4).tolist()} / {whole_ms[k]:.4f}"
                              for k in wholes) + f" [{smi}]")
            del shards, calls

    # 17c: one decode step on per-rank caches cut from a full-width prefill
    attn = llm.attention
    hkv, d = cfg.llm.num_key_value_heads, cfg.llm.head_dim
    max_len = s + 8
    ck = torch.zeros((b, max_len, hkv, d), dtype=torch.bfloat16, device=device)
    cv = torch.zeros_like(ck)
    kv_mask = torch.zeros((b, max_len), dtype=torch.bool, device=device)
    kv_mask[:, : s + 1] = True
    with torch.no_grad():
        cos_c, sin_c = p17_rope(cfg.llm, max_len, device)
        _, (kn, vn) = attn(h_llm, cos_c, sin_c, pos, ck, cv, 0,
                           torch.zeros((), dtype=torch.int32, device=device), kv_mask)
        ck[:, :s], cv[:, :s] = kn, vn
        x1 = torch.randn((b, 1, cfg.llm.hidden_size), generator=gen,
                         device=device).to(torch.bfloat16)
        pos1 = torch.full((b, 1), s, device=device)
        idx = torch.full((), s, dtype=torch.int32, device=device)
        starts = dec.window_starts(kv_mask, b, device)

        def step(m, k, v):
            return m(x1, cos_c, sin_c, pos1, k, v, s, idx, kv_mask, False, None, starts)[0]

        reset()
        want = step(attn, ck, cv)
        whole_launches = dec.cached_decode_attention.launches
        whole_step_ms = time_ms(lambda: step(attn, ck, cv), P17_ITERS)
        for t in P17_TENSOR:
            shards = p17_shards(attn, t)
            n = hkv // t
            caches = [(ck[:, :, r * n:(r + 1) * n].contiguous(),
                       cv[:, :, r * n:(r + 1) * n].contiguous()) for r in range(t)]
            reset()
            got = sum(step(sh, k, v) for sh, (k, v) in zip(shards, caches))
            torch.cuda.synchronize()
            k8 = dec.cached_decode_attention.launches
            kernel = dec.decode_kernel_supported(shards[0].hq, shards[0].hkv, d)
            err = relative_l2(got.float(), want.float())
            if k8 != (t if kernel else 0) or whole_launches != 1 or err > DECODE_TOL:
                raise RuntimeError(f"17c tensor {t}: K8 launches {k8} (whole {whole_launches}; "
                                   f"kernel at {shards[0].hq}/{shards[0].hkv}: {kernel}); rel L2 "
                                   f"{err:.3e} (max {DECODE_TOL})")
            ms = [time_ms(lambda sh=sh, k=k, v=v: step(sh, k, v), P17_ITERS)
                  for sh, (k, v) in zip(shards, caches)]
            out["c"][t] = dict(k8=k8, kernel=kernel, rel_l2=err, shard_ms=ms,
                               whole_ms=whole_step_ms)
            phase("tensor", f"17c tensor {t}: a decode step of the decoder's attention, B = {b} "
                  f"after {s} prefilled rows, on per-rank caches of {n} kv heads: rel L2 "
                  f"{err:.3e} to the whole step; "
                  + (f"K8 {k8} launches at {shards[0].hq}/{shards[0].hkv} heads"
                     if kernel else f"{shards[0].hq}/{shards[0].hkv} heads fail "
                     "decode_kernel_supported: the two-part path, no K8")
                  + f"; ms per shard {np.round(ms, 4).tolist()} against the whole step's "
                  f"{whole_step_ms:.4f} [{smi}]")
    del vit, llm, attn, ck, cv
    gc.collect()
    torch.cuda.empty_cache()

    # 17b: a stage-2 LoRA step of the same layers, forward and backward
    _, (vit, llm) = p17_layers(device, lora=True)
    bt, st = P17_TRAIN_ROWS
    x_llm_t = x_llm[:bt, :st]
    pos_t = pos[:bt, :st]
    u_vit = torch.randn(x_vit.shape, generator=gen, device=device).to(torch.bfloat16)
    u_llm = torch.randn(x_llm_t.shape, generator=gen, device=device).to(torch.bfloat16)

    def train_run(attns_vit, mlps_vit, attns_llm, mlps_llm):
        # each layer draws from its own generator, and each rank's shards of
        # a layer share one seeded alike: every rank draws the whole layer's
        # masks in the whole layer's order
        for layer, attns, mlps in ((vit, attns_vit, mlps_vit), (llm, attns_llm, mlps_llm)):
            layer.train()
            set_generator(layer, torch.Generator(device=device).manual_seed(5))
            for a, m in zip(attns or [], mlps or []):
                g = torch.Generator(device=device).manual_seed(5)
                for mod in (a, m):
                    mod.train()
                    set_generator(mod, g)
        xv = x_vit.detach().requires_grad_()
        xl = x_llm_t.detach().requires_grad_()
        yv = p17_vit(vit, attns_vit, mlps_vit, xv, n_tok)
        yl = p17_llm(llm, attns_llm, mlps_llm, xl, cos, sin, pos_t)
        ((yv.float() * u_vit.float()).sum() + (yl.float() * u_llm.float()).sum()).backward()
        return xv.grad, xl.grad

    def adapter_grads(whole, shards):
        """{name: gradient} of `whole`'s adapters: its own, or the shards'
        gathered (split leaves) and summed (whole leaves)."""
        if shards is None:
            return {n: p.grad for n, p in whole.named_parameters() if p.grad is not None}
        leaves = split_leaves(shards[0])
        per = [dict(sh.named_parameters()) for sh in shards]
        out = {}
        for n, p in whole.named_parameters():
            if not p.requires_grad:
                continue
            if n in leaves:
                out[n] = leaves[n].unshard([q[n].grad for q in per])
            else:
                out[n] = sum(q[n].grad for q in per)
        return out

    for m in (vit, llm):
        m.zero_grad(set_to_none=True)
    reset()
    dxv_w, dxl_w = train_run(None, None, None, None)
    whole_counts = counts()
    want = {**{f"vit.attn.{n}": g for n, g in adapter_grads(vit.attn, None).items()},
            **{f"vit.mlp.{n}": g for n, g in adapter_grads(vit.mlp, None).items()},
            **{f"llm.attention.{n}": g for n, g in adapter_grads(llm.attention, None).items()},
            **{f"llm.feed_forward.{n}": g
               for n, g in adapter_grads(llm.feed_forward, None).items()}}
    for t in P17_TENSOR:
        va, vm = p17_shards(vit.attn, t), p17_shards(vit.mlp, t)
        la, lm = p17_shards(llm.attention, t), p17_shards(llm.feed_forward, t)
        for m in va + vm + la + lm:
            m.zero_grad(set_to_none=True)
        reset()
        with tally_heads(fa) as tally:
            dxv, dxl = train_run(va, vm, la, lm)
            torch.cuda.synchronize()
        launched = counts()
        p17_require(launched, f"b tensor {t}")
        got = {**{f"vit.attn.{n}": g for n, g in adapter_grads(vit.attn, va).items()},
               **{f"vit.mlp.{n}": g for n, g in adapter_grads(vit.mlp, vm).items()},
               **{f"llm.attention.{n}": g for n, g in adapter_grads(llm.attention, la).items()},
               **{f"llm.feed_forward.{n}": g
                  for n, g in adapter_grads(llm.feed_forward, lm).items()}}
        if set(got) != set(want):
            raise RuntimeError(f"17b tensor {t}: adapters {sorted(set(got) ^ set(want))}")
        errs = {n: relative_l2(got[n].float(), want[n].float()) for n in want}
        errs["dx_vit"] = relative_l2(dxv.float(), dxv_w.float())
        errs["dx_llm"] = relative_l2(dxl.float(), dxl_w.float())
        worst = max(errs, key=errs.get)
        hv, hl = cfg.vision.num_attention_heads // t, cfg.llm.num_attention_heads // t
        kv = cfg.llm.num_key_value_heads // t
        want_tally = {f"{form} {h}/{k}/{dd}": t for form in ("lse", "bwd")
                      for h, k, dd in ((hv, hv, 64), (hl, kv, cfg.llm.head_dim))}
        if dict(tally) != want_tally or errs[worst] > TRAIN_GRAD_TOL:
            raise RuntimeError(f"17b tensor {t}: launches by head shape {dict(tally)}, "
                               f"expected {want_tally}; worst gradient {worst} rel L2 "
                               f"{errs[worst]:.3e} (max {TRAIN_GRAD_TOL})")
        out["b"][t] = dict(tally=dict(tally), counts=launched, worst=worst,
                           worst_rel_l2=errs[worst], whole_counts=whole_counts)
        phase("tensor", f"17b tensor {t}: a stage-2 LoRA step (r={LORA_RANK}, dropout 0.05 "
              f"drawn whole and sliced) of the ViT layer ({P17_VIT_FRAMES} frames) and the "
              f"decoder layer ({bt} x {st}), forward and backward: {len(want)} adapter "
              f"gradients and both inputs' gathered from the shards, worst {worst} rel L2 "
              f"{errs[worst]:.3e} to the whole layers' (max {TRAIN_GRAD_TOL}); launches by "
              f"head shape {dict(tally)} (the whole layers: {whole_counts}) [{smi}]")
        del va, vm, la, lm
    phase("tensor", f"17 phase 17 {time.perf_counter() - t_start:.1f} s [{smi}]")
    return out


# --------------------------------------------------------------- phase 18 --

P18_FIXTURE = os.path.join("tests", "data", "orbax_stage1")
P18_HASHES = os.path.join("tests", "data", "orbax_stage1.sha256.json")
P18_STEPS = 2  # steps before the checkpoint, and after it
# 18b: resumed against straight, relative, on losses and on each trainable
# tensor's L2 (bit-equal expected, as phase 16's runs are; any difference printed)
P18_TOL = 1e-5
# 18c: the readout of SlowFast + motion_mlp under w8a8_motion against bf16,
# relative L2 (int8 rounding of every residual stage's pointwise convs)
P18_MOTION_TOL = 0.1


def run_fixture_read(smi: str) -> dict:
    """18a: the committed JAX-written stage-1 checkpoint, read without JAX,
    orbax or tensorstore: every leaf's dtype, shape and SHA-256 against the
    recorded ones."""
    import hashlib

    from aigv_assessor_torch.utils import orbax_format, zstd

    if not zstd.available():
        raise RuntimeError(f"18a: {zstd.LIBRARY} does not load here")
    with open(P18_HASHES) as f:
        want = json.load(f)
    t0 = time.perf_counter()
    tree = {orbax_format.leaf_name(k): t
            for k, t in orbax_format.read_tree(os.path.join(P18_FIXTURE, "1", "default"))
            if t is not None}
    read_s = time.perf_counter() - t0
    if set(tree) != set(want):
        raise RuntimeError(f"18a: leaves {sorted(set(tree) ^ set(want))[:5]} differ")
    names = {torch.float32: "float32", torch.bfloat16: "bfloat16", torch.int32: "int32"}
    for name, t in tree.items():
        got = {"dtype": names.get(t.dtype, str(t.dtype)), "shape": list(t.shape),
               "sha256": hashlib.sha256(
                   t.contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()).hexdigest()}
        if got != want[name]:
            raise RuntimeError(f"18a: {name} is {got}, recorded {want[name]}")
    nbytes = sum(t.numel() * t.element_size() for t in tree.values())
    phase("orbax", f"18a the JAX-written tiny stage-1 checkpoint ({P18_FIXTURE}): {len(tree)} "
          f"leaves, {nbytes} bytes, every dtype, shape and SHA-256 as recorded; read in "
          f"{read_s:.2f} s through {zstd.LIBRARY} [{smi}]")
    return {"leaves": len(tree)}


def split(timings: dict) -> str:
    return ", ".join(f"{k[:-2]} {v:.2f}" for k, v in timings.items())


def du_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(d, f)) for d, _, files in os.walk(path)
               for f in files)


def run_stage1_resume(device, px_u8, n_vit: int, n_llm: int, smi: str) -> dict:
    """18b: the 2B stage-1 trainer at the training CLI's shape (batch 4):
    P18_STEPS steps, the checkpoint in JAX's layout, P18_STEPS more; then a
    fresh trainer (other weights drawn) restored from the checkpoint and
    its P18_STEPS steps. Losses and trainable parameters bit-equal, the
    frozen ones equal to the first run's."""
    from aigv_assessor_torch.cli import stage1_train
    from aigv_assessor_torch.core.config import LLM_2B, AssessorConfig
    from aigv_assessor_torch.ops import flash_attention as fa
    from aigv_assessor_torch.train.checkpoint import CheckpointManager
    from aigv_assessor_torch.train.trainer import TrainConfig

    cfg = AssessorConfig(llm=LLM_2B, stage=1)
    batch, ctx_id = stage1_batch(cfg, px_u8)
    cfg = cfg.replace(img_context_token_id=ctx_id)
    total = 2 * P18_STEPS
    with tempfile.TemporaryDirectory() as d:
        def trainer_for(seed):
            tc = TrainConfig(output_dir=os.path.join(d, f"out{seed}"), learning_rate=TRAIN_LR,
                             warmup_ratio=0.0, lr_scheduler_type="cosine", num_train_epochs=1,
                             save_steps=0, seed=0)
            model = stage1_train.build_training_model(cfg, device=device, seed=seed,
                                                      train_config=tc)
            return model, tc, stage1_train.Trainer(model, tc, total)

        def steps(model, tc, trainer):
            stage1_train.train_steps(model, [batch] * P18_STEPS, tc, trainer=trainer)
            with open(os.path.join(tc.output_dir, "train_log.jsonl")) as f:
                return [json.loads(line)["loss"] for line in f][-P18_STEPS:]

        model, tc, trainer = trainer_for(0)
        losses = steps(model, tc, trainer)
        mgr = CheckpointManager(os.path.join(d, "checkpoints"))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mgr.save(P18_STEPS, trainer)
        save_s = time.perf_counter() - t0
        save_split = dict(mgr.timings)
        on_disk = du_bytes(os.path.join(d, "checkpoints", str(P18_STEPS)))
        losses += steps(model, tc, trainer)
        straight = {n: t.detach().cpu() for n, t in model.state_dict().items()}
        trained = set(trainer.trainable)
        del model, trainer
        gc.collect()
        torch.cuda.empty_cache()

        model, tc, trainer = trainer_for(1)  # other weights: the restore brings them all
        for c in training_counters(fa):
            c.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mgr = CheckpointManager(os.path.join(d, "checkpoints"))
        mgr.restore(trainer)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        restore_split = dict(mgr.timings)
        if trainer.step != P18_STEPS:
            raise RuntimeError(f"18b: restored step {trainer.step}, saved {P18_STEPS}")
        resumed = steps(model, tc, trainer)
        counts = {c.__name__: c.launches for c in training_counters(fa)}
        state = {n: t.detach().cpu() for n, t in model.state_dict().items()}
        del model, trainer
        gc.collect()
        torch.cuda.empty_cache()
    per_step = {"flash_attention_qkv": n_vit, "flash_attention_qkv_lse": 2 * n_llm,
                "flash_attention_qkv_bwd_kernel": n_llm}
    want = {n: per_step.get(n, 0) * P18_STEPS for n in counts}
    if counts != want:
        raise RuntimeError(f"18b: launches {counts} after the restore, expected {want}")
    loss_diff = max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(resumed, losses[P18_STEPS:]))
    if not np.isfinite(losses + resumed).all() or loss_diff > P18_TOL:
        raise RuntimeError(f"18b: resumed losses {resumed}, straight {losses} differ by "
                           f"{loss_diff:.3e} relative (max {P18_TOL})")
    differ = {n: relative_l2(state[n].float(), straight[n].float()) for n in state
              if not torch.equal(state[n], straight[n])}
    frozen = sorted(n for n in differ if n not in trained)
    if frozen or any(e > P18_TOL for e in differ.values()):
        raise RuntimeError(f"18b: tensors differ from the straight run's: frozen {frozen[:5]}, "
                           f"trainable {sorted(differ.items(), key=lambda kv: -kv[1])[:3]}")
    gb = on_disk / 1e9
    phase("orbax", f"18b stage 1 InternVL2-2B at batch {px_u8.shape[0]} x {px_u8.shape[1]} "
          f"frames {px_u8.shape[2]}px: {P18_STEPS} steps, checkpoint in JAX's orbax layout, "
          f"{P18_STEPS} more, against a fresh trainer restored from it: losses "
          f"{losses} straight, {resumed} resumed ("
          f"{'bit-equal' if loss_diff == 0 else f'{loss_diff:.3e} relative'}); "
          f"{len(state) - len(differ)} of {len(state)} tensors bit-equal, the largest "
          f"relative L2 of a trainable one {max(differ.values(), default=0.0):.3e} (max "
          f"{P18_TOL}); save {save_s:.2f} s ({split(save_split)}), restore {restore_s:.2f} s "
          f"({split(restore_split)}), {gb:.3f} GB on "
          f"disk ({gb / save_s:.2f} GB/s written, {gb / restore_s:.2f} GB/s read); launches "
          f"after the restore {counts} [{smi}]")
    return dict(counts=counts, save_s=save_s, restore_s=restore_s, gb=gb, losses=losses,
                save_split=save_split, restore_split=restore_split,
                resumed=resumed, loss_diff=loss_diff, bit_equal=not differ and loss_diff == 0)


def run_motion_w8a8(device, px_u8, smi: str) -> dict:
    """18c: SlowFast-R50 + motion_mlp at the 2B chunk in bf16, with and
    without `w8a8_motion`, on the same weights: the readout within
    P18_MOTION_TOL relative L2, ms per forward both ways, and the int8
    products counted (one per pointwise conv of the residual stages)."""
    from aigv_assessor_torch.core.config import LLM_2B, AssessorConfig
    from aigv_assessor_torch.models.assessor import ProjectorMLP
    from aigv_assessor_torch.models.motion import ConvBN, SlowFastR50
    from aigv_assessor_torch.ops import w8a8
    from aigv_assessor_torch.ops.preprocess import resize_normalize

    cfg = AssessorConfig(llm=LLM_2B)
    gen = torch.Generator(device="cpu").manual_seed(18)
    plain = SlowFastR50(cfg.motion)
    for m in plain.modules():  # He-normal convolutions, batch norm near the identity
        if isinstance(m, torch.nn.Conv3d):
            fan_in = m.weight[0].numel()
            m.weight.data = torch.randn(m.weight.shape, generator=gen) * (2.0 / fan_in) ** 0.5
        elif isinstance(m, ConvBN):
            m.bn.scale.uniform_(0.8, 1.2, generator=gen)
            m.bn.var.uniform_(0.5, 1.5, generator=gen)
    quant = SlowFastR50(cfg.motion, w8a8=True)
    quant.load_state_dict(plain.state_dict())
    plain, quant = (m.to(device, torch.bfloat16).eval() for m in (plain, quant))
    torch.manual_seed(18)
    head = ProjectorMLP(cfg.motion.feature_dim, cfg.llm.hidden_size, torch.float32)
    head = head.to(device, torch.bfloat16).eval()
    pv = resize_normalize(px_u8.to(device), size=IMAGE, dtype=torch.bfloat16)
    pointwise = sum(isinstance(m, ConvBN) and m.pointwise_w8a8 for m in quant.modules())

    calls = []
    real = w8a8._int_mm

    def counted(xq, weight):
        calls.append(tuple(xq.shape))
        return real(xq, weight)

    with torch.no_grad():
        want = head(plain(pv)).float()
        with mock.patch.object(w8a8, "_int_mm", counted):
            got = head(quant(pv)).float()
        per_forward = len(calls)
        err = relative_l2(got, want)
        plain_ms = time_ms(lambda: head(plain(pv)), 5)
        with mock.patch.object(w8a8, "_int_mm", counted):
            w8a8_ms = time_ms(lambda: head(quant(pv)), 5)
    if per_forward != pointwise or not pointwise:
        raise RuntimeError(f"18c: {per_forward} int8 products a forward, {pointwise} pointwise "
                           "convs switched")
    if not torch.isfinite(got).all() or not err <= P18_MOTION_TOL:
        raise RuntimeError(f"18c: readout relative L2 {err:.4f} against bf16 "
                           f"(max {P18_MOTION_TOL})")
    phase("motion", f"18c SlowFast-R50 + motion_mlp, {tuple(px_u8.shape[:4])} frames, bf16: "
          f"w8a8_motion readout within {err:.4f} relative L2 of the cuDNN path (max "
          f"{P18_MOTION_TOL}); {w8a8_ms:.2f} ms a forward under w8a8_motion against "
          f"{plain_ms:.2f} ms in bf16; {per_forward} torch._int_mm calls a forward (one per "
          f"switched pointwise conv), rows {calls[0][0]}..{calls[per_forward - 1][0]} [{smi}]")
    return dict(err=err, w8a8_ms=w8a8_ms, plain_ms=plain_ms, int_mm=per_forward)


def run_phase18(device, smi, px_u8, *, n_vit: int, n_llm: int) -> dict:
    t0 = time.perf_counter()
    out = dict(a=run_fixture_read(smi),
               b=run_stage1_resume(device, px_u8, n_vit, n_llm, smi),
               c=run_motion_w8a8(device, px_u8, smi))
    phase("orbax", f"18 phase 18 {time.perf_counter() - t0:.1f} s [{smi}]")
    return out



def main() -> int:
    t_start = time.perf_counter()
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
    from aigv_assessor_torch.ops import fp8_matmul as f8
    from aigv_assessor_torch.ops import int8_matmul as wo
    from aigv_assessor_torch.ops import quant_fuse as qf
    from aigv_assessor_torch.ops.attention import two_part_cached_attention
    from aigv_assessor_torch.ops.preprocess import resize_normalize

    # 2. build, always from the checkout's sources
    libs = (fa.LIB, fa.LIB_BWD, qf.LIB, wo.LIB, dec.LIB, f8.LIB)
    for lib in libs:
        lib.path.unlink(missing_ok=True)
    build_s = cuda_build.build(libs, verbose=True)
    phase("build", f"{', '.join(lib.source.name for lib in libs)} -> "
          f"{', '.join(lib.path.name for lib in libs)} for sm_90a in {build_s:.2f} s")

    # 3. kernels against their plain versions
    shapes = check_attention(fa, device)
    train_shapes = check_attention_training(fa, device)
    feeds = check_feeds(qf, device)
    check_feed_ties(qf, device)
    check_quantizers_bit_equal(device)
    separate = check_attention_separate(fa, device)
    separate_train = check_attention_separate_training(fa, device, SEPARATE_TRAIN)
    matmuls = check_weight_only(wo, device)
    decode = check_decode_attention(dec, two_part_cached_attention, device)
    fp8 = check_fp8(f8, device)

    # 3b. the fp8 decode probe: K9's path (and K7's int4 candidate)
    probe = run_fp8_probe(f8, wo, smi)

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
                    fa.flash_attention_qkv_lse, fa.flash_attention_qkv_bwd_kernel,
                    dec.decode_attention, dec.cached_decode_attention)
        for c in counters:
            c.launches = 0
        wo.int8_matmul.form_launches = dict.fromkeys(wo.FORMS, 0)
        wo.int4_matmul.form_launches = dict.fromkeys(wo.FORMS, 0)
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
                 "flash_attention_qkv_bwd_kernel",
                 "decode_attention", "cached_decode_attention")
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
        # every projection's 4 x 2113 rows take the GEMM form
        forms = dict(getattr(wo, matmul).form_launches)
        want_forms = dict(dict.fromkeys(wo.FORMS, 0), gemm=5 * n_llm * CHUNKS)
        if forms != want_forms:
            raise RuntimeError(f"{label}: matmul forms {forms} for {CHUNKS} forwards, expected "
                               f"{want_forms}")
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
              f"videos: launches per forward {per_fwd} (forms {forms}), {ms_q:.1f} ms/chunk (bf16 "
              f"{ms_bf16:.1f}), peak {peak_q:.2f} GiB allocated (bf16 {peak_bf16:.2f}), weights "
              f"{weights_q:.2f} GiB (bf16 {weights_bf16:.2f}), init {init_s:.1f} s; readout rel "
              f"L2 kernel vs plain versions {rel_plain:.3e}, vs the bf16 model of the "
              f"dequantized weights {rel_deq:.3e} (tol {WEIGHT_ONLY_READOUT_TOL}), cosine to "
              f"bf16 {cosine:.5f}{f' (tol {INT8_COSINE})' if bits == 8 else ''}; scores "
              f"{np.round(arr_q[:, 0], 4).tolist()} [{smi}]")
        return counts_q, forms, ms_q

    counts_int8, forms_int8, ms_int8 = run_weight_only_slice(8)
    torch.cuda.empty_cache()
    counts_int4, forms_int4, ms_int4 = run_weight_only_slice(4)
    torch.cuda.empty_cache()

    # 7. the stage-2 training slice
    train_counts, train_ms, train_peak = run_train_slice(cfg, device, ids, mask, px_u8, rng,
                                                         per_forward, smi)
    torch.cuda.empty_cache()

    # 13e. the same training with the ViT under a remat policy; 13f. the ViT
    # at another grid and depth
    remat = run_remat_policy(cfg, device, ids, mask, px_u8, smi, full_ms=train_ms,
                             full_peak=train_peak)
    vit_grids = run_vit_grids(cfg, device, smi, n_vit=n_vit)

    # 7b. stage-1 training at 2B
    run_stage1_slice(device, px_u8, n_vit, n_llm, smi)
    torch.cuda.empty_cache()

    # 7c. the training CLIs from a meta file
    train_clis = run_train_clis(device, smi, train_ms, n_vit=n_vit, n_llm=n_llm)

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

    # 10b. the stage-1 and stage-2 eval CLIs on a meta file
    eval_s = run_eval_clis(device, smi, n_vit=n_vit, n_llm=n_llm)

    # 13a-c. a LoRA checkpoint's adapters live over quantized bases, in the
    # eval CLI and in generation
    ref, lcfg = lora_reference(cfg, device)
    merged = merged_checkpoint(ref, lcfg, device)
    lora_served = run_lora_quantized(
        ref, lcfg, merged, device, ids, mask, px_u8, chunks[0], ids_pn, mask_pn, smi,
        n_vit=n_vit, n_llm=n_llm, base_ms=dict(w8a8=ms_w8a8, int8=ms_int8, int4=ms_int4))
    lora_eval = run_lora_eval(ref, merged, device, smi, n_vit=n_vit, n_llm=n_llm,
                              eval_s=eval_s)
    lora_gen = run_lora_generation(ref, lcfg, merged, device, ids[:, 0], px_u8, smi,
                                   n_vit=n_vit, n_llm=n_llm)
    del ref, merged
    gc.collect()
    torch.cuda.empty_cache()

    # 11. InternVL2-26B: every earlier model is gone; the 26B model takes
    # 47.5 GiB in bf16
    gc.collect()
    torch.cuda.empty_cache()
    big = run_26b(device, ids, mask, px_u8, videos, ids_pn, mask_pn, smi)
    gc.collect()
    torch.cuda.empty_cache()

    # 13d. InternVL2-26B quantized, built tensor by tensor
    big_q = run_26b_quantized(device, ids, mask, px_u8, videos, ids_pn, mask_pn, smi,
                              big.pop("cut_readout_bf16"))

    # 12. the HTTP scoring service at 2B, bf16 and W8A8
    served = run_serve(device, smi, n_vit=n_vit, n_llm=n_llm)

    # 14. frames resized on the card; checkpoints and stored quantized trees
    # from disk, the merge tool, the grafts: every artifact under one
    # temporary directory
    phase14 = run_phase14(device, smi, ids, mask, px_u8, n_vit=n_vit, n_llm=n_llm)
    gc.collect()
    torch.cuda.empty_cache()

    # 15. InternVL2-4B (Phi-3-mini, D = 96) and InternVL2-1B (Qwen2-0.5B, tied)
    p15 = run_phase15(device, smi, videos)
    gc.collect()
    torch.cuda.empty_cache()

    # 16. more than one card, at world 1: the training CLI under FSDP2
    # through torch.distributed.run, and sharded scoring
    p16 = run_phase16(device, smi, ids, mask, px_u8, n_vit=n_vit, n_llm=n_llm)
    gc.collect()
    torch.cuda.empty_cache()

    # 17. the tensor mesh axis: each rank's shard of a 2B ViT layer and
    # decoder layer on the one card, the partials summed here
    p17 = run_phase17(device, smi)
    gc.collect()
    torch.cuda.empty_cache()

    # 18. checkpoints in JAX's orbax layout: the committed JAX-written one
    # read here, the 2B stage-1 trainer saved and resumed; w8a8_motion
    p18 = run_phase18(device, smi, px_u8, n_vit=n_vit, n_llm=n_llm)

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
    # the forward's two schedules (csrc/flash_attn_fwd.cu's header)
    fwd_design = (
        "causal: one persistent block an SM over (q tile, q head, sample) items dealt "
        "snake-wise in rounds of the grid, longest group of q tiles first over the whole launch "
        "(one q tile a group while the batch's K and V fit in 32 MiB, one more a group for every "
        "32 MiB past that), q tiles aligned to the end of the sequence (the ragged one first, "
        "from row 0), the K/V ring, the consumers' turns and a second Q buffer carried from one "
        "item into the next; not causal: one block per (q tile, q head, sample)")
    # the backward's one kernel a key tile (csrc/flash_attn_bwd.cu's header)
    bwd_design = (
        "three launches: delta (and the dQ order's counters set to 0); one block per (128-key "
        "tile, kv head, sample) computing S^T, dP^T, dV, dK and dQ's share (5 products a "
        "(query, key) pair, the Pallas pair's 7 less S and dP run twice), dK / dV in registers "
        "summed over the group, dQ's share one item later by the two consumer warpgroups in "
        "turn, added by a writer warp into an fp32 running sum per q tile in a fixed order "
        "(first write, then bulk fp32 reductions, each after the q tile's counter reads its "
        "rank); dq from the sums, scaled, in bf16")
    kernels = [
        dict(name="flash_attn_qkv_fwd", **fwd_src, design=fwd_design, launches=launches_bhsd,
             max_abs_err=max(r["max_abs_err"] for r in shapes.values()),
             ms=per_unit(shapes, "ms"), plain_ms=per_unit(shapes, "plain_ms"),
             bound_ms=per_unit(shapes, "bound_ms"), bound_by=shapes["vit"]["bound_by"],
             library_ms=per_unit(shapes, "library_ms"), library=sdpa_note,
             unit="one scoring forward: 24 launches at the vit shape, 24 at the llm shape",
             shapes=shapes),
        dict(name="flash_attn_qkv_fwd_bsd", **fwd_src, design=fwd_design,
             launches=counts8["flash_attention_qkv"],
             max_abs_err=max(r["bsd_max_abs_err"] for r in shapes.values()),
             ms=per_unit(shapes, "bsd_ms"), plain_ms=per_unit(shapes, "bsd_plain_ms"),
             bound_ms=per_unit(shapes, "bound_ms"), bound_by=shapes["vit"]["bound_by"],
             library_ms=per_unit(shapes, "library_ms"),
             library=sdpa_note + "; its output is head-major, the dense rows would cost a copy",
             unit="one W8A8 scoring forward: 24 + 24 launches"),
        dict(name="flash_attn_qkv_fwd_lse", **fwd_src, design=fwd_design,
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
        dict(name="flash_attn_qkv_bwd", **bwd_src, design=bwd_design,
             replaces="aigv_assessor_tpu/ops/pallas_attention.py:384",
             also_replaces="aigv_assessor_tpu/ops/pallas_attention.py:455",
             launches=train_counts["flash_attention_qkv_bwd_kernel"],
             max_abs_err=max(max(r["max_abs_err"].values()) for r in train_shapes.values()),
             ms=per_unit(train_shapes, "bwd_ms"), plain_ms=per_unit(train_shapes, "plain_bwd_ms"),
             bound_ms=per_unit_bound("bwd"),
             bound_by=train_shapes["vit"]["bounds"]["bwd"]["bound_by"],
             library_ms=per_unit(train_shapes, "library_bwd_ms"),
             library=sdpa_note + ": its backward alone gives dq, dk and dv in one call; "
             "plain_ms is the whole plain backward",
             unit="one training micro-batch: 24 + 24 calls of the entry (its three launches)"),
    ]
    llm_sep = separate["llm"]
    kernels.append(dict(
        name="flash_attn_fwd", route="cuda", design=fwd_design,
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
    for bits, replaces, counts_q, forms_q in ((8, 31, counts_int8, forms_int8),
                                              (4, 113, counts_int4, forms_int4)):
        table = matmuls[bits]

        def per_forward_sum(key, m=None):
            return n_llm * sum(per_layer * (table[name][key] if m is None else
                                            table[name]["decode"][m][key])
                               for name, (_, _, per_layer) in PROJECTIONS.items())
        checked = [r for r in table.values() if "max_abs_err" in r]
        checked += [*table["borders"].values(), *table["gemm_edges"].values(),
                    *table["other_models"].values()]
        m_dec = DECODE_ROWS[0]
        kernels.append(dict(
            name=f"weight_only_int{bits}_matmul", route="cuda",
            source="aigv_assessor_torch/csrc/weight_only_matmul.cu",
            replaces=f"aigv_assessor_tpu/ops/int8_matmul.py:{replaces}",
            launches=counts_q[f"int{bits}_matmul"],
            max_abs_err=max(r["max_abs_err"] for r in checked),
            ms=per_forward_sum("ms"), plain_ms=per_forward_sum("plain_ms"),
            bound_ms=per_forward_sum("bound_ms"), bound_by=table["w2"]["bound_by"],
            library_ms=per_forward_sum("library_ms"),
            library="F.linear in bf16 on a weight dequantized beforehand: the same product "
            f"with {16 // bits} times the weight bytes",
            unit=f"one int{bits} scoring forward: 24 layers x (wqkv, wo, w1, w3, w2) at M = "
            f"{PREFILL_ROWS}, the GEMM form; launches_by_form are those of the scoring run",
            launches_by_form=forms_q,
            forms={
                "gemm": dict(ms=per_forward_sum("ms"), unit="one scoring forward"),
                "unaligned": dict(ms=per_forward_sum("unaligned_ms"),
                                  unit="one scoring forward, the same inputs through the "
                                  "unaligned form (the mma.sync body)"),
                "gemv": dict(
                    ms=per_forward_sum("ms", m_dec) + table["lm_head"]["ms"],
                    library_ms=(per_forward_sum("library_ms", m_dec)
                                + table["lm_head"]["library_ms"]),
                    bound_ms=per_forward_sum("bound_ms", m_dec) + table["lm_head"]["bound_ms"],
                    bound_by=table["lm_head"]["bound_by"],
                    launches=gen_int8["forms"]["gemv"] if bits == 8 else None,
                    unit=f"one decode step at M = {m_dec}: 24 layers x (wqkv, wo, w1, w3, w2) "
                    "and the LM head, weights from device memory; launches are those of the int8 "
                    f"{GEN_TOKENS}-token generate"),
            }, shapes=table))
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
        launches=gen_bf16["counts"]["cached_decode_attention"],
        max_abs_err=max(r["max_abs_err"] for r in decode.values()),
        ms=n_llm * path["ms"], plain_ms=n_llm * path["plain_ms"],
        bound_ms=n_llm * path["bound_ms"], bound_by=path["bound_by"],
        library_ms=n_llm * path["library_ms"], eager_ms=n_llm * path["eager_ms"],
        library="F.scaled_dot_product_attention with a one-token query on head-major views "
        "of the cache rows below end, enable_gqa: the window without the current token",
        window_ms=n_llm * path["window_ms"], window_eager_ms=n_llm * path["window_eager_ms"],
        window_plain_ms=n_llm * path["window_plain_ms"],
        window_bound_ms=n_llm * path["window_bound_ms"],
        window_merge_ms=n_llm * path["window_merge_ms"],
        window_merge_eager_ms=n_llm * path["window_merge_eager_ms"],
        eager_two_part_ms=n_llm * path["two_part_ms"],
        unit=f"one decode step of the bf16 generate: {n_llm} launches of the fused entry "
        f"(cached_decode_attention: the window and the current token) at B = {BATCH}, end = "
        f"{DECODE_SHAPES['path'][5]}, cache layers read from device memory; ms, plain_ms, "
        "library_ms and eager_two_part_ms are device times by CUDA graph replay, eager_ms is "
        "the wrapper called launch by launch with the host's cost; window_* are the same "
        "kernel without the merge (decode_attention) and with the eager merge_new_token after "
        "it; launches are those of one "
        f"{GEN_TOKENS}-token generate ({gen_int8['counts']['cached_decode_attention']} with int8 "
        "weights, 0 under kv_int8)", shapes=decode))
    # K2's training forms: one 26B training micro-batch, n_vit launches of each
    # at the vit_6b_train shape (the logsumexp form twice: pass and recompute)
    n_vit26 = big["n_vit"]
    unit26 = SEPARATE_TRAIN["vit_6b_train"]
    k2_unit = (f"one InternVL2-26B training micro-batch of {TRAIN_26B_VIDEOS} videos: "
               f"{{}} launches at the vit_6b_train shape ({unit26[0]} frames)")
    k2 = separate_train["vit_6b_train"]

    def k2_entry(name, key, kind, counter, replaces, times, library_ms, library, design):
        return dict(
            name=name, route="cuda", source=f"aigv_assessor_torch/csrc/{key}",
            replaces=f"aigv_assessor_tpu/ops/pallas_attention.py:{replaces}",
            launches=big["train_counts"][counter],
            max_abs_err=max((r["lse_max_abs_err"] if kind == "fwd_lse" else
                             max(r["max_abs_err"][g] for g in kind_grads[kind]))
                            for r in separate_train.values()),
            ms=times * n_vit26 * k2[f"{kind_ms[kind]}_ms"], design=design,
            plain_ms=times * n_vit26 * k2["plain_lse_ms" if kind == "fwd_lse" else "plain_bwd_ms"],
            bound_ms=times * n_vit26 * k2["bounds"][kind]["bound_ms"],
            bound_by=k2["bounds"][kind]["bound_by"], library_ms=times * n_vit26 * library_ms,
            library=library, unit=k2_unit.format(times * n_vit26), shapes=separate_train)

    kind_grads = {"bwd": ("dq", "dk", "dv")}
    kind_ms = {"fwd_lse": "lse", "bwd": "bwd"}
    k2_lib = ("F.scaled_dot_product_attention on head-major views of the same q, k, v, k and "
              "v cut at kv_valid")
    kernels += [
        k2_entry("flash_attn_fwd_lse", "flash_attn_fwd.cu", "fwd_lse", "flash_attention_lse",
                 352, 2, k2["library_ms"], k2_lib + " (forward; it keeps its own logsumexp)",
                 fwd_design),
        dict(k2_entry("flash_attn_bwd", "flash_attn_bwd.cu", "bwd", "flash_attention_bwd_kernel",
                      602, 1, k2["library_bwd_ms"], k2_lib + ": its backward alone (on a kept "
                      "forward) gives dq, dk and dv in one call (its forward + backward is under "
                      "shapes, library_fwd_bwd_ms); plain_ms is the whole plain backward",
                      bwd_design),
             also_replaces="aigv_assessor_tpu/ops/pallas_attention.py:618"),
    ]
    m8 = [fp8[f"{name}_m8"] for name in FP8_SHAPES]
    kernels.append(dict(
        name="fp8_matmul", route="cuda", source="aigv_assessor_torch/csrc/fp8_matmul.cu",
        replaces="benchmarks/fp8_decode_probe.py:40",
        launches=probe["counts"]["fp8_matmul"],
        max_abs_err=max(r["max_abs_err"] for r in fp8.values() if "max_abs_err" in r),
        ms=sum(r["ms"] for r in m8), plain_ms=sum(r["plain_ms"] for r in m8),
        bound_ms=sum(r["bound_ms"] for r in m8), bound_by=m8[0]["bound_by"],
        library_ms=sum(r["library_ms"] for r in m8),
        fixed_ms=fp8["fixed"]["ms"],
        form={name: fp8[f"{name}_m8"]["form"] for name in FP8_SHAPES},
        split={name: fp8[f"{name}_m8"]["split"] for name in FP8_SHAPES},
        library="F.linear in bf16 on the weight dequantized beforehand: the same product with "
        "twice the weight bytes (torch._scaled_mm takes x in fp8 too: another function)",
        unit="the probe's three decode matvecs of InternLM2-1.8B at M = 8 (wqkv 2048 -> 4096, "
        "w1 / w3 fused 2048 -> 16384, w2 8192 -> 2048), one launch each, weights from device "
        "memory; launches are those of the probe's run (tools/fp8_decode_probe.run), its only "
        "caller: no model serves fp8 weights", shapes=fp8))
    # phase 15's forms: Phi-3-mini's D = 96 (the forward's own D = 96 body) and
    # Qwen2-0.5B's 14 / 2 heads, each per unit of its path at its shapes;
    # launches are the phase's runs' at that head shape (`tally_heads`)
    n4, n1 = 32, 24
    f15, t15, d15, r15 = (p15["fwd"], p15["train"]["phi3_train"], p15["decode"],
                          p15["rows"])
    tally4, tally1 = p15["4b"]["bf16"]["tally"], p15["1b"]["bf16"]["tally"]
    train_tally = p15["train_tally"]

    def p15_fwd(name, key, n, launches, unit):
        r = f15[key]
        return dict(name=name, **fwd_src, design=fwd_design, launches=launches,
                    max_abs_err=r["max_abs_err"],
                    ms=n * r["ms"], plain_ms=n * r["plain_ms"], bound_ms=n * r["bound_ms"],
                    bound_by=r["bound_by"], library_ms=n * r["library_ms"], library=sdpa_note,
                    unit=unit, shapes={key: r})

    kernels += [
        p15_fwd("flash_attn_qkv_fwd_d96", "phi3", n4, tally4.get("bhsd 32/32/96", 0),
                f"one InternVL2-4B scoring forward: {n4} decoder launches at the phi3 shape "
                "(D = 96's own body); launches: the bf16 scoring run's (15b) at 32/32/96"),
        p15_fwd("flash_attn_qkv_fwd_qwen2", "qwen2", n1, tally1.get("bhsd 14/2/64", 0),
                f"one InternVL2-1B scoring forward: {n1} decoder launches at 14 / 2 heads of 64; "
                "launches: the bf16 scoring run's (15f) at 14/2/64"),
        dict(name="flash_attn_qkv_fwd_lse_d96", **fwd_src, design=fwd_design,
             launches=train_tally.get("lse 32/32/96", 0), max_abs_err=t15["lse_max_abs_err"],
             ms=2 * n4 * t15["lse_ms"], plain_ms=2 * n4 * t15["plain_lse_ms"],
             bound_ms=2 * n4 * t15["bounds"]["fwd_lse"]["bound_ms"],
             bound_by=t15["bounds"]["fwd_lse"]["bound_by"],
             library_ms=2 * n4 * f15["phi3_train"]["library_ms"],
             library=sdpa_note + " (forward; it keeps its own logsumexp)",
             unit=f"one InternVL2-4B training micro-batch of {P15_TRAIN_VIDEOS} videos: first "
             f"pass and recompute, 2 x {n4} decoder launches; launches: 15e's at 32/32/96",
             shapes=p15["train"]),
        dict(name="flash_attn_qkv_bwd_d96", **bwd_src, design=bwd_design,
             replaces="aigv_assessor_tpu/ops/pallas_attention.py:384",
             also_replaces="aigv_assessor_tpu/ops/pallas_attention.py:455",
             launches=train_tally.get("bwd 32/32/96", 0),
             max_abs_err=max(t15["max_abs_err"].values()),
             ms=n4 * t15["bwd_ms"], plain_ms=n4 * t15["plain_bwd_ms"],
             bound_ms=n4 * t15["bounds"]["bwd"]["bound_ms"],
             bound_by=t15["bounds"]["bwd"]["bound_by"], library_ms=n4 * t15["library_bwd_ms"],
             library="as for flash_attn_qkv_bwd",
             unit=f"one InternVL2-4B training micro-batch: {n4} decoder calls of the entry; "
             "launches: 15e's at 32/32/96"),
        dict(name="flash_attn_fwd_d96", route="cuda", design=fwd_design,
             source="aigv_assessor_torch/csrc/flash_attn_fwd.cu",
             replaces="aigv_assessor_tpu/ops/pallas_attention.py:352",
             launches=p15["4b"]["int8"]["counts"]["flash_attention"],
             max_abs_err=r15["max_abs_err"], ms=n4 * r15["ms"], plain_ms=n4 * r15["plain_ms"],
             bound_ms=n4 * r15["bound_ms"], bound_by=r15["bound_by"],
             library_ms=n4 * r15["library_ms"],
             library="F.scaled_dot_product_attention on head-major views of the same q, k, v",
             unit=f"one InternVL2-4B int8 / int4 scoring forward: {n4} launches at the phi3 "
             "shape, bshd views of one row-major projection; launches: the int8 run's (15b)",
             shapes={"phi3_rows": r15}),
    ]
    for key, n, gen, label in (("phi3", n4, p15["gen4"], "d96"), ("qwen2", n1, p15["gen1"],
                                                                 "qwen2")):
        r = d15[key]
        kernels.append(dict(
            name=f"decode_attention_{label}", route="cuda",
            source="aigv_assessor_torch/csrc/decode_attention.cu",
            replaces="aigv_assessor_tpu/ops/decode_attention.py:64",
            launches=gen["counts"]["cached_decode_attention"], max_abs_err=r["max_abs_err"],
            ms=n * r["ms"], plain_ms=n * r["plain_ms"], bound_ms=n * r["bound_ms"],
            bound_by=r["bound_by"], library_ms=n * r["library_ms"],
            library="as for decode_attention", eager_ms=n * r["eager_ms"],
            design=(f"{r['form']} form, {r['nsplit']} piece(s) a window: " + (
                "one block of 8 warps an SM over each whole window, one tile ahead, two kv "
                "heads of a sample in step as a thread-block cluster, read-once L2 policy"
                if r["form"] == "wide" else
                "two blocks an SM, the pieces of a window merged in a thread-block cluster")),
            unit=f"one decode step at {r['shape']}: {n} launches of the fused entry; launches: "
            f"the bf16 {P15_GEN_TOKENS}-token generate of "
            f"{'InternVL2-4B (15c)' if key == 'phi3' else 'InternVL2-1B (15f)'}",
            shapes={key: r}))
    ids_by_name = {
        "flash_attn_qkv_fwd": "K1 bhsd", "flash_attn_qkv_fwd_bsd": "K1 bsd",
        "flash_attn_qkv_fwd_lse": "K1 lse", "flash_attn_qkv_bwd": "K3a / K3b",
        "flash_attn_fwd": "K2 fwd",
        "weight_only_int8_matmul": "K6", "weight_only_int4_matmul": "K7", "ln_quant": "K4a",
        "gelu_quant": "K4b", "ident_quant": "K4c", "rmsnorm_quant": "K5a",
        "silu_mul_quant": "K5b", "decode_attention": "K8", "flash_attn_fwd_lse": "K2 lse",
        "flash_attn_bwd": "K2 dq / dk-dv", "fp8_matmul": "K9",
        "flash_attn_qkv_fwd_d96": "K1 bhsd D=96", "flash_attn_qkv_fwd_qwen2": "K1 bhsd 14/2",
        "flash_attn_qkv_fwd_lse_d96": "K1 lse D=96", "flash_attn_qkv_bwd_d96": "K3a / K3b D=96",
        "flash_attn_fwd_d96": "K2 fwd D=96",
        "decode_attention_d96": "K8 D=96", "decode_attention_qwen2": "K8 14/2"}
    # the entry points' paths (phases 7c and 12), each run with the counts at 0
    s2, s1 = train_clis["stage2"]["counts"], train_clis["stage1"]["counts"]
    bf16_serve, w8a8_serve = served["bf16"]["counts"], served["w8a8"]["counts"]
    by_path = {
        "flash_attn_qkv_fwd": {"train_cli_stage2 (evals)": s2["flash_attention_qkv"],
                               "train_cli_stage1 (evals, frozen ViT)": s1["flash_attention_qkv"],
                               "serve_bf16": bf16_serve["flash_attention_qkv"]},
        "flash_attn_qkv_fwd_bsd": {"serve_w8a8": w8a8_serve["flash_attention_qkv"]},
        "ln_quant": {"serve_w8a8": w8a8_serve["layernorm_quant"]},
        "gelu_quant": {"serve_w8a8": w8a8_serve["gelu_quant"]},
        "ident_quant": {"serve_w8a8": w8a8_serve["quant_rows"]},
    }
    for kernel, counter in (("flash_attn_qkv_fwd_lse", "flash_attention_qkv_lse"),
                            ("flash_attn_qkv_bwd", "flash_attention_qkv_bwd_kernel")):
        by_path[kernel] = {"train_cli_stage2": s2[counter], "train_cli_stage1": s1[counter],
                           "train_vit_remat_policy (13e, one micro-batch)":
                           remat["policy"]["counts"][counter]}
    # phase 13's paths: adapters live over quantized bases (13a, one forward),
    # their generation (13c), InternVL2-26B quantized (13d, one forward), the
    # ViT at another grid and depth (13f)
    lq = {mode: lora_served[mode]["counts"] for mode in lora_served}
    bq = {mode: big_q[mode]["counts"] for mode in big_q}
    by_path["flash_attn_qkv_fwd"].update({
        "lora_int8 (13a, ViT)": lq["int8"]["flash_attention_qkv"],
        "lora_int4 (13a, ViT)": lq["int4"]["flash_attention_qkv"],
        "lora_generate (13c, ViT)": lora_gen["live"]["counts"]["flash_attention_qkv"],
        f"vit_{VIT_SIZE}px (13f)": vit_grids["336px"]["launches"],
        "vit_select_layer_-2 (13f)": vit_grids["select_layer_-2"]["launches"]})
    by_path["flash_attn_qkv_fwd_bsd"].update({
        "lora_w8a8 (13a)": lq["w8a8"]["flash_attention_qkv"],
        "internvl2_26b_w8a8 (13d, decoder)": bq["w8a8"]["flash_attention_qkv"]})
    by_path["flash_attn_fwd"] = {
        "lora_int8 (13a, decoder)": lq["int8"]["flash_attention"],
        "lora_int4 (13a, decoder)": lq["int4"]["flash_attention"],
        **{f"internvl2_26b_{m} (13d)": bq[m]["flash_attention"] for m in bq}}
    for bits in (8, 4):
        counter = f"int{bits}_matmul"
        by_path[f"weight_only_int{bits}_matmul"] = {
            f"lora_int{bits} (13a)": lq[f"int{bits}"][counter],
            f"internvl2_26b_int{bits} (13d)": bq[f"int{bits}"][counter]}
    for kernel, counter in (("ln_quant", "layernorm_quant"), ("gelu_quant", "gelu_quant"),
                            ("ident_quant", "quant_rows"), ("rmsnorm_quant", "rmsnorm_quant"),
                            ("silu_mul_quant", "silu_mul_quant")):
        by_path.setdefault(kernel, {}).update({
            "lora_w8a8 (13a, adapters: feeds off)": lq["w8a8"][counter],
            "internvl2_26b_w8a8 (13d)": bq["w8a8"][counter]})
    by_path["decode_attention"] = {
        "lora_generate (13c)": lora_gen["live"]["counts"]["cached_decode_attention"]}
    # phase 14's paths (one forward each): frames resized on the card, the
    # stored int8 / int4 files, the int8 file under --w8a8
    fq = {mode: phase14["files"][mode]["counts"] for mode in ("int8", "int4", "w8a8")}
    by_path["flash_attn_qkv_fwd"].update({
        "resized_frames (14a)": phase14["resize"]["chunk_launches"],
        "int8_file (14c, ViT)": fq["int8"]["flash_attention_qkv"],
        "int4_file (14c, ViT)": fq["int4"]["flash_attention_qkv"]})
    by_path["flash_attn_qkv_fwd_bsd"]["int8_file_w8a8 (14c)"] = fq["w8a8"]["flash_attention_qkv"]
    by_path["flash_attn_fwd"].update({
        "int8_file (14c, decoder)": fq["int8"]["flash_attention"],
        "int4_file (14c, decoder)": fq["int4"]["flash_attention"]})
    for bits in (8, 4):
        by_path[f"weight_only_int{bits}_matmul"][f"int{bits}_file (14c)"] = (
            fq[f"int{bits}"][f"int{bits}_matmul"])
    for kernel, counter in (("ln_quant", "layernorm_quant"), ("gelu_quant", "gelu_quant"),
                            ("ident_quant", "quant_rows")):
        by_path[kernel]["int8_file_w8a8 (14c)"] = fq["w8a8"][counter]
    # phase 15's paths for the forms of earlier slices: the ViT's attention in
    # both models, the quantize feeds and matmuls of the 4B / 1B decoders
    s4, s1b = p15["4b"], p15["1b"]
    by_path["flash_attn_qkv_fwd"].update({
        "internvl2_4b_bf16 (15b, ViT)": tally4.get("bhsd 16/16/64", 0),
        "internvl2_1b_bf16 (15f, ViT)": tally1.get("bhsd 16/16/64", 0),
        "internvl2_4b_int8 (15b, ViT)": s4["int8"]["counts"]["flash_attention_qkv"]})
    by_path["flash_attn_qkv_fwd_bsd"].update({
        f"internvl2_{m} (15, ViT)": t[key]["tally"].get("bsd 16/16/64", 0)
        for m, t, key in (("4b_w8a8", s4, "w8a8"), ("4b_w8a8_fused", s4, "w8a8_fused"),
                          ("1b_w8a8", s1b, "w8a8"))})
    for kernel, form in (("flash_attn_qkv_fwd_lse", "lse"), ("flash_attn_qkv_bwd", "bwd")):
        by_path[kernel]["internvl2_4b_train (15e, ViT)"] = train_tally.get(f"{form} 16/16/64", 0)
    for kernel, counter in (("ln_quant", "layernorm_quant"), ("gelu_quant", "gelu_quant"),
                            ("ident_quant", "quant_rows"), ("rmsnorm_quant", "rmsnorm_quant"),
                            ("silu_mul_quant", "silu_mul_quant")):
        by_path[kernel].update({
            "internvl2_4b_w8a8 (15b)": s4["w8a8"]["counts"][counter],
            "internvl2_4b_w8a8_fused (15b)": s4["w8a8_fused"]["counts"][counter],
            "internvl2_1b_w8a8 (15f)": s1b["w8a8"]["counts"][counter]})
    for bits in (8, 4):
        by_path[f"weight_only_int{bits}_matmul"][f"internvl2_4b_int{bits} (15b)"] = (
            s4[f"int{bits}"]["counts"][f"int{bits}_matmul"])
    by_path["flash_attn_fwd"]["internvl2_4b_int4 (15b, decoder)"] = (
        s4["int4"]["counts"]["flash_attention"])
    # phase 16's paths: the stage-2 training CLI under FSDP2 (torchrun, world
    # 1), sharded scoring (one chunk)
    fsdp_counts = p16["train"]["fsdp"]["counts"]
    for kernel, counter in (("flash_attn_qkv_fwd_lse", "flash_attention_qkv_lse"),
                            ("flash_attn_qkv_bwd", "flash_attention_qkv_bwd_kernel")):
        by_path[kernel]["stage2_train_fsdp2 (16a, 3 steps)"] = fsdp_counts[counter]
    p16_bf16, p16_w8a8 = p16["score"]["bf16"]["counts"], p16["score"]["w8a8"]["counts"]
    by_path["flash_attn_qkv_fwd"]["sharded_scoring (16b, one chunk)"] = (
        p16_bf16["flash_attention_qkv"])
    by_path["flash_attn_qkv_fwd_bsd"]["sharded_scoring_w8a8 (16b, one chunk)"] = (
        p16_w8a8["flash_attention_qkv"])
    for kernel, counter in (("ln_quant", "layernorm_quant"), ("gelu_quant", "gelu_quant"),
                            ("ident_quant", "quant_rows")):
        by_path[kernel]["sharded_scoring_w8a8 (16b, one chunk)"] = p16_w8a8[counter]
    # phase 17's paths: the shards of one 2B ViT layer and one decoder layer
    # for tensor 2 and 4 (K1 at the local heads; K1 lse and K3 in the LoRA
    # step; K8 at tensor 2, none at 4 where the step takes the two-part path)
    for t in P17_TENSOR:
        by_path["flash_attn_qkv_fwd"][f"tensor_{t}_shards (17a, one layer each)"] = (
            p17["a"][t]["counts"].get("flash_attention_qkv", 0))
        for kernel, counter in (("flash_attn_qkv_fwd_lse", "flash_attention_qkv_lse"),
                                ("flash_attn_qkv_bwd", "flash_attention_qkv_bwd_kernel")):
            by_path[kernel][f"tensor_{t}_shards (17b, one layer each)"] = (
                p17["b"][t]["counts"].get(counter, 0))
        by_path.setdefault("decode_attention", {})[f"tensor_{t}_shards (17c, one step)"] = (
            p17["c"][t]["k8"])
    # phase 18's path: the 2B stage-1 trainer restored from its checkpoint
    # and stepped (K1 for the frozen ViT, K1 lse, K3a, K3b for the decoder)
    for kernel, counter in (("flash_attn_qkv_fwd", "flash_attention_qkv"),
                            ("flash_attn_qkv_fwd_lse", "flash_attention_qkv_lse"),
                            ("flash_attn_qkv_bwd", "flash_attention_qkv_bwd_kernel")):
        by_path[kernel][f"stage1_resumed (18b, {P18_STEPS} steps)"] = p18["b"]["counts"][counter]
    for k in kernels:
        k["id"] = ids_by_name[k["name"]]
        if k["name"] in by_path:
            k["launches_by_path"] = by_path[k["name"]]
    phase("total", f"{time.perf_counter() - t_start:.1f} s [{smi}]")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if len(sys.argv) > 2 and sys.argv[1] == P16_CHILD:
        sys.exit(p16_child(sys.argv[2], sys.argv[3:]))
    sys.exit(main())
