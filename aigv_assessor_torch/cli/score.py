"""Batch video scoring (`aigv_assessor_tpu/cli/score.py`), the device side.

- `build_serving_model`: the stage-2 model on a device in the serving
  precision (bf16; W8A8 with `w8a8=True`; weight-only W8A16 with `int8=True`
  or W4A16 with `int4=True`, the JAX CLI's `--w8a8`, `--int8`, `--int4`),
  with weights made from a seed.
- `score_batch`: uint8 frames -> normalization -> `score_perspectives`, one
  call per chunk of videos (the JAX CLI's jitted `score_batch`).
- `score_chunks`: the chunk loop: pads the tail chunk to the batch size and
  scales the scores back to the MOS range.

The host side of the JAX CLI (video decode, the tokenizer and prompt
building, the video list, the flags and the CSV) is not ported yet
(ROADMAP.md, Queue 1): callers hand in prompt ids and uint8 frames.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np
import torch

from aigv_assessor_torch.core.config import AssessorConfig
from aigv_assessor_torch.core.precision import Precision
from aigv_assessor_torch.models.assessor import AIGVAssessor
from aigv_assessor_torch.models.loading import init_random_, quantize_for_serving
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
    (~8.8 GB at 2B). `w8a8` with `int8` or `int4` raises ValueError."""
    w8a8 = w8a8 or precision.w8a8
    int4 = int4 or precision.int4_weights
    int8 = (int8 or precision.int8_weights) and not int4
    float_precision = dataclasses.replace(
        precision, w8a8=False, int8_weights=False, int4_weights=False)
    target = dataclasses.replace(float_precision, w8a8=w8a8, int8_weights=int8,
                                 int4_weights=int4)  # raises on w8a8 with int8/int4
    with torch.device("meta"):
        model = AIGVAssessor(config, float_precision)
    model = init_random_(model.to_empty(device=device), seed)  # fp32
    if target != float_precision:
        state = quantize_for_serving(model.state_dict(), config, int8=int8, int4=int4)
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
) -> torch.Tensor:
    """-> [B, P] fp32 scores in the model's range (mos / 100). Frames are
    normalized with the ImageNet statistics, as the JAX CLI's default."""
    pixel_values = resize_normalize(
        pixels_u8, size=pixels_u8.shape[-2], dtype=model.precision.compute_dtype
    )
    return model.score_perspectives(input_ids, pixel_values, attention_mask)


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

    With more than one perspective the JAX CLI shares the prompts' common
    prefix by default; that path is not ported yet, so P > 1 needs
    `shared_prefix=False`."""
    n_persp = ids_pn.shape[0]
    if n_persp > 1 and shared_prefix:
        raise NotImplementedError(
            "shared-prefix perspective scoring is not ported yet: ROADMAP.md, "
            "Queue 1, shared-prefix scoring; pass shared_prefix=False to score "
            "each prompt in full"
        )
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
        scores = score_batch(model, ids, pixels, mask)
        if pending is not None:
            flush(*pending)
        pending = (len(chunk), scores)
    if pending is not None:
        flush(*pending)
    return rows
