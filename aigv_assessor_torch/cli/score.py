"""Batch video scoring (`aigv_assessor_tpu/cli/score.py`), the device side.

- `build_serving_model`: the stage-2 model on a device in the serving
  precision (bf16; W8A8 with `w8a8=True`; weight-only W8A16 with `int8=True`
  or W4A16 with `int4=True`, the JAX CLI's `--w8a8`, `--int8`, `--int4`;
  `kv_int8=True` for an int8 KV cache under generation), with weights made
  from a seed.
- `score_batch`: uint8 frames -> normalization -> `score_perspectives`, one
  call per chunk of videos (the JAX CLI's jitted `score_batch`).
- `compute_shared_prefix_len`: the longest token prefix the perspective
  prompts share, if shared-prefix scoring can use it.
- `score_chunks`: the chunk loop: pads the tail chunk to the batch size and
  scales the scores back to the MOS range. With more than one perspective it
  shares the prompts' common prefix by default (`--shared_prefix`).

The host side of the JAX CLI (video decode, the tokenizer and prompt
building, the video list, the flags and the CSV) is not ported yet
(ROADMAP.md, Queue 1): callers hand in prompt ids and uint8 frames.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

from aigv_assessor_torch.core.config import AssessorConfig
from aigv_assessor_torch.core.precision import Precision
from aigv_assessor_torch.models.assessor import AIGVAssessor
from aigv_assessor_torch.models.loading import (
    init_random_,
    quantize_for_serving,
    serving_precision,
)
from aigv_assessor_torch.ops.preprocess import resize_normalize


def build_serving_model(
    config: AssessorConfig,
    *,
    device: torch.device | str,
    precision: Precision = Precision(),
    seed: int = 0,
    int8: bool = False,
    int4: bool = False,
    w8a8: bool = False,
    kv_int8: bool = False,
) -> AIGVAssessor:
    """The model on `device` in `precision.compute_dtype`, as the JAX CLI's
    `build_serving_stack` makes it: fp32 weights from `init_random_(seed)`,
    quantized from those fp32 values for W8A8 (`w8a8=True` or
    `precision.w8a8`: both towers' projections) or for weight-only serving
    (`int8=True` / `int4=True` or the precision's `int8_weights` /
    `int4_weights`: the decoder's projections and the LM head; int4 first
    when both are set), then everything else cast to the compute dtype, the
    quantization scales kept fp32. One seed gives the same base weights in
    every precision. The fp32 weights are held only while the model is built
    (~8.8 GB at 2B). `w8a8` with `int8` or `int4` raises ValueError.
    `kv_int8` (or `precision.kv_int8`) changes no weight: generation then
    keeps its KV cache in int8, under any of the modes above."""
    target = serving_precision(precision, w8a8=w8a8, int8=int8, int4=int4, kv_int8=kv_int8)
    float_precision = dataclasses.replace(
        target, w8a8=False, int8_weights=False, int4_weights=False)
    with torch.device("meta"):
        model = AIGVAssessor(config, float_precision)
    model = init_random_(model.to_empty(device=device), seed)  # fp32
    if target != float_precision:
        state = quantize_for_serving(model.state_dict(), config, int8=target.int8_weights,
                                     int4=target.int4_weights)
        del model
        with torch.device("meta"):
            model = AIGVAssessor(config, target)
        model.load_state_dict(state, strict=True, assign=True)
        del state
    return model.to(precision.compute_dtype).eval()


@torch.inference_mode()
def score_batch(
    model: AIGVAssessor,
    input_ids: torch.Tensor,  # [B, P, N]
    pixels_u8: torch.Tensor,  # [B, T, H, W, 3] uint8
    attention_mask: torch.Tensor,  # [B, P, N]
    shared_prefix_len: Optional[int] = None,
) -> torch.Tensor:
    """-> [B, P] fp32 scores in the model's range (mos / 100). Frames are
    normalized with the ImageNet statistics, as the JAX CLI's default.
    `shared_prefix_len`: see `AIGVAssessor.score_perspectives`."""
    pixel_values = resize_normalize(
        pixels_u8, size=pixels_u8.shape[-2], dtype=model.precision.compute_dtype
    )
    return model.score_perspectives(input_ids, pixel_values, attention_mask,
                                    shared_prefix_len=shared_prefix_len)


def compute_shared_prefix_len(
    prompts: Sequence[Sequence[int]],
    img_context_token_id: int,
    *,
    min_prefix: int = 8,
    min_suffix: int = 4,
) -> int:
    """Longest common token prefix of the perspective prompts (each without
    its padding), or 0 when shared-prefix scoring cannot use it: with fewer
    than two prompts; when the prefix is shorter than `min_prefix`; when it
    does not hold EVERY `<IMG_CONTEXT>` token (the frames and the motion
    embedding are spliced in the prefix pass only); or when some perspective
    keeps fewer than `min_suffix` tokens after it, so that its read-out at
    (length - 4) would fall outside its own suffix."""
    if len(prompts) < 2:
        return 0
    shortest = min(len(p) for p in prompts)
    first = prompts[0]
    prefix_len = shortest
    for p in prompts[1:]:
        i = 0
        while i < prefix_len and p[i] == first[i]:
            i += 1
        prefix_len = i
    ctx = np.nonzero(np.asarray(first) == img_context_token_id)[0]
    if (
        prefix_len < min_prefix
        or ctx.size == 0
        or int(ctx.max()) >= prefix_len
        or shortest - prefix_len < min_suffix
    ):
        return 0
    return prefix_len


def score_chunks(
    model: AIGVAssessor,
    chunks: Sequence[Sequence[np.ndarray]],  # chunks of [T, H, W, 3] uint8 videos
    ids_pn: np.ndarray,  # [P, N] prompt ids, right-padded
    mask_pn: np.ndarray,  # [P, N] bool, True = real token
    *,
    batch_size: int,
    mos_scale: float = 100.0,
    shared_prefix: bool = True,
) -> List[List[float]]:
    """Score every video of every chunk; one row of P MOS-range scores per
    video. A short chunk is padded with copies of its last video to the batch
    size, so every call has the same shape. Scores are read back one chunk
    late, so the host prepares chunk N+1 while the device runs chunk N.

    `shared_prefix`, with more than one perspective: the LLM runs the
    prompts' common token prefix (the system turn and every frame and motion
    slot) once per video and the question suffixes against that cache
    (`score_perspectives(shared_prefix_len=)`). Where the prompts share no
    usable prefix (`compute_shared_prefix_len` gives 0) each prompt runs in
    full, as with `shared_prefix=False`."""
    n_persp = ids_pn.shape[0]
    prefix_len = 0
    if shared_prefix and n_persp > 1:
        prompts = [ids_pn[i, : int(mask_pn[i].sum())] for i in range(n_persp)]
        prefix_len = compute_shared_prefix_len(prompts, model.config.img_context_token_id)
    device = next(model.parameters()).device
    ids = torch.as_tensor(np.tile(ids_pn[None], (batch_size, 1, 1)), device=device)
    mask = torch.as_tensor(np.tile(mask_pn[None], (batch_size, 1, 1)), device=device)

    rows: List[List[float]] = []

    def flush(n_real: int, scores: torch.Tensor) -> None:
        for s in scores[:n_real].cpu().tolist():
            rows.append([v * mos_scale for v in s])

    pending = None
    for chunk in chunks:
        if not 0 < len(chunk) <= batch_size:
            raise ValueError(f"chunk of {len(chunk)} videos for batch size {batch_size}")
        videos = list(chunk) + [chunk[-1]] * (batch_size - len(chunk))
        pixels = torch.as_tensor(np.stack(videos)).to(device)
        scores = score_batch(model, ids, pixels, mask, prefix_len or None)
        if pending is not None:
            flush(*pending)
        pending = (len(chunk), scores)
    if pending is not None:
        flush(*pending)
    return rows
