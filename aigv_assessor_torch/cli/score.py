"""Batch video scoring (`aigv_assessor_tpu/cli/score.py`): a folder of
videos (or a .jsonl with a "video" per line) -> a CSV of MOS-range scores,
one column per question ("perspective"), and a JSON summary line.

    python -m aigv_assessor_torch.cli.score --videos DIR_OR_JSONL \
        --question "How would you rate the static quality of this video?" \
        --question "How would you rate the temporal smoothness of this video?" \
        --model_scale 2b --w8a8 True --batch_size 4 --out scores.csv

It runs on `--device` (default `cuda`; the tests pass `cpu`). Weights come
from `--model_name_or_path` (a directory with the JAX package's parameter
tree, `params.msgpack` or `params.safetensors`, float or stored int8 /
int4; else a reference-format checkpoint: config.json, tokenizer.json or
tokenizer.model, sharded safetensors) or from seed 0 at `--model_scale`. Under `--w8a8` the fused quantize feeds follow JAX's
`AIGV_FUSE_QUANT` / `AIGV_QUANT_ROWS` switches (`cli/common.py`).

- `list_videos`, `build_prompt_ids`: the video list and the scoring prompt,
  as the JAX CLI builds them.
- `main`: videos are decoded by a thread pool (`--workers`) with a two-chunk
  window ahead of the device; the tail chunk is padded to the batch;
  `score_chunks` reads each chunk's scores back one chunk late, so the host
  prepares chunk N+1 while the device runs chunk N.
- `score_batch`: frames -> normalization (`--normalize_type`) ->
  `score_perspectives`, one call per chunk. uint8 frames (the default
  `--device_preprocess True`) are normalized on the device; with
  `--device_preprocess False` the host's fp32 `transform_frames` output is
  taken as it is, as JAX's `load_one` hands it over (normalized with the
  `--normalize_type` statistics, where JAX's host path always takes
  ImageNet's).
- `compute_shared_prefix_len`: the longest token prefix the perspective
  prompts share, if shared-prefix scoring can use it.
- `score_chunks`: the chunk loop, over any iterable of decoded chunks.
- `build_serving_model` (from `cli/common.py`): the model in a serving
  precision from fp32 weights.
"""

from __future__ import annotations

import argparse
import csv
import json
import logging
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Iterable, Iterator, List, Optional, Sequence

import numpy as np
import torch

from aigv_assessor_torch.cli.args import _bool
from aigv_assessor_torch.cli.common import build_serving_model, build_serving_stack
from aigv_assessor_torch.data.conversation import get_conv_template
from aigv_assessor_torch.data.preprocess import expand_image_tokens
from aigv_assessor_torch.data.video import frames_to_uint8, load_video, transform_frames
from aigv_assessor_torch.models.assessor import AIGVAssessor
from aigv_assessor_torch.ops.preprocess import resize_normalize

__all__ = ["build_prompt_ids", "build_serving_model", "compute_shared_prefix_len",
           "list_videos", "main", "score_batch", "score_chunks"]

logger = logging.getLogger(__name__)

VIDEO_EXTS = (".mp4", ".avi", ".mov", ".mkv", ".webm", ".gif")


def list_videos(path: str) -> List[str]:
    if os.path.isdir(path):
        return [
            os.path.join(path, f)
            for f in sorted(os.listdir(path))
            if f.lower().endswith(VIDEO_EXTS)
        ]
    if path.endswith(".jsonl"):
        with open(path) as f:
            return [json.loads(line)["video"] for line in f if line.strip()]
    return [path]


def build_prompt_ids(tokenizer, template_name, question, num_frames, num_image_token):
    """Stage-2 scoring prompt: Frame{i} blocks + the motion slot + the
    question + the canonical answer, so that the read-out position (len - 4)
    exists."""
    blocks = "\n".join(f"Frame{i + 1}: <image>" for i in range(num_frames))
    q = blocks + "\nMotion Feature: <image>\n" + question
    conv = get_conv_template(template_name)
    conv.append_message(conv.roles[0], q)
    conv.append_message(conv.roles[1], "The quality of the video is good.")
    text = conv.get_prompt()
    text = expand_image_tokens(text, [num_image_token] * num_frames + [1])
    return tokenizer.encode(text)


@torch.inference_mode()
def score_batch(
    model: AIGVAssessor,
    input_ids: torch.Tensor,  # [B, P, N]
    pixels: torch.Tensor,  # [B, T, H, W, 3] uint8, or normalized float
    attention_mask: torch.Tensor,  # [B, P, N]
    shared_prefix_len: Optional[int] = None,
    normalize_type: str = "imagenet",
) -> torch.Tensor:
    """-> [B, P] fp32 scores in the model's range (mos / 100). uint8 frames
    are normalized on the device with the `normalize_type` statistics; float
    frames are taken as already normalized. `shared_prefix_len`: see
    `AIGVAssessor.score_perspectives`."""
    dtype = model.precision.compute_dtype
    if pixels.dtype == torch.uint8:
        pixel_values = resize_normalize(pixels, size=pixels.shape[-2],
                                        normalize_type=normalize_type, dtype=dtype)
    else:
        pixel_values = pixels.to(dtype)
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
    chunks: Iterable[Sequence[np.ndarray]],  # chunks of [T, H, W, 3] videos
    ids_pn: np.ndarray,  # [P, N] prompt ids, right-padded
    mask_pn: np.ndarray,  # [P, N] bool, True = real token
    *,
    batch_size: int,
    mos_scale: float = 100.0,
    shared_prefix: bool = True,
    normalize_type: str = "imagenet",
) -> List[List[float]]:
    """Score every video of every chunk; one row of P MOS-range scores per
    video. Videos are uint8 frames, or float frames already normalized
    (`score_batch`). A short chunk is padded with copies of its last video
    to the batch size, so every call has the same shape. Scores are read
    back one chunk late, so the host prepares chunk N+1 while the device
    runs chunk N; `chunks` is iterated lazily, so it may decode as it goes.

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
        scores = score_batch(model, ids, pixels, mask, prefix_len or None, normalize_type)
        if pending is not None:
            flush(*pending)
        pending = (len(chunk), scores)
    if pending is not None:
        flush(*pending)
    return rows


def _decoded_chunks(paths: Sequence[Sequence[str]], load_one, workers: int) -> Iterator[list]:
    """Each chunk's decoded videos, in order, decoded by a pool of `workers`
    threads that keeps two chunks ahead of the chunk being handed out."""
    with ThreadPoolExecutor(workers) as pool:
        futures = {}

        def submit(ci):
            if ci < len(paths) and ci not in futures:
                futures[ci] = [pool.submit(load_one, p) for p in paths[ci]]

        submit(0)
        submit(1)
        for ci in range(len(paths)):
            videos = [f.result() for f in futures.pop(ci)]
            submit(ci + 2)
            yield videos


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--model_name_or_path", default="")
    ap.add_argument("--model_scale", default="auto", choices=["auto", "tiny", "2b", "8b"])
    ap.add_argument("--videos", required=True)
    ap.add_argument(
        "--question", action="append", default=None,
        help="repeatable: each occurrence is one scoring perspective; all "
             "perspectives share one ViT/motion encode per video",
    )
    ap.add_argument("--batch_size", type=int, default=16)
    ap.add_argument("--num_segments", type=int, default=8)
    ap.add_argument("--out", default="scores.csv")
    ap.add_argument("--bf16", type=_bool, default=True)
    ap.add_argument("--max_seq_length", type=int, default=4096)
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--mos_scale", type=float, default=100.0,
                    help="multiply model scores back to MOS range (stage-2 "
                         "trains on mos/100)")
    ap.add_argument("--normalize_type", default="imagenet",
                    choices=["imagenet", "clip", "siglip"])
    ap.add_argument("--device_preprocess", type=_bool, default=True,
                    help="decode to uint8 at the model's input size on the host and "
                         "normalize on the device; False = the host's fp32 PIL path "
                         "(training parity)")
    ap.add_argument("--int8", type=_bool, default=False,
                    help="W8A16 serving: int8 decoder weights decoded in the matmul kernel")
    ap.add_argument("--w8a8", type=_bool, default=False,
                    help="int8 x int8 products in both towers (ops/w8a8.py); "
                         "AIGV_FUSE_QUANT / AIGV_QUANT_ROWS pick the fused feeds")
    ap.add_argument("--int4", type=_bool, default=False,
                    help="W4A16 serving: nibble-packed int4 decoder weights")
    ap.add_argument("--shared_prefix", type=_bool, default=True,
                    help="with >1 perspectives: prefill the common prompt "
                         "prefix (system turn + frame/motion tokens) ONCE "
                         "per video and run the per-perspective question "
                         "suffixes against the shared KV cache")
    ap.add_argument("--device", default="cuda",
                    help="torch device to score on (cpu for tests)")
    args = ap.parse_args(argv)

    config, model, tokenizer = build_serving_stack(
        model_name_or_path=args.model_name_or_path,
        model_scale=args.model_scale,
        max_seq_length=args.max_seq_length,
        bf16=args.bf16,
        int8=args.int8,
        int4=args.int4,
        w8a8=args.w8a8,
        device=args.device,
    )
    image_size = config.force_image_size or config.vision.image_size

    videos = list_videos(args.videos)
    questions = args.question or ["How would you rate the static quality of this video?"]
    n_persp = len(questions)
    logger.info("scoring %d videos x %d perspectives", len(videos), n_persp)

    # one prompt per perspective, right-padded to a common length: the whole
    # [B, P, N] batch runs in one call
    prompts = [
        build_prompt_ids(tokenizer, config.template, q, args.num_segments,
                         config.num_image_token)
        for q in questions
    ]
    max_n = max(len(p) for p in prompts)
    ids_pn = np.full((n_persp, max_n), tokenizer.pad_token_id, np.int64)
    mask_pn = np.zeros((n_persp, max_n), bool)
    for i, p in enumerate(prompts):
        ids_pn[i, : len(p)] = p
        mask_pn[i, : len(p)] = True
    if args.shared_prefix and n_persp > 1:
        prefix_len = compute_shared_prefix_len(prompts, config.img_context_token_id)
        if prefix_len:
            logger.info("shared prompt prefix: %d of %d tokens prefilled once per video",
                        prefix_len, max_n)
        else:
            logger.warning("perspective prompts share no usable prefix; falling back to "
                           "independent per-perspective prefills")

    def load_one(path):
        # scaled native decode straight to the input size (GIF and folder
        # readers decode at their own size; the resize below covers them)
        frames = load_video(path, num_segments=args.num_segments, out_size=image_size)
        if args.device_preprocess:
            return frames_to_uint8(frames, input_size=image_size)
        # the ImageNet statistics whatever --normalize_type says, as JAX's CLI
        # normalizes on the host (aigv_assessor_tpu/cli/score.py:219)
        return transform_frames(frames, input_size=image_size)

    bs = args.batch_size
    paths = [videos[i : i + bs] for i in range(0, len(videos), bs)]
    t_start = time.perf_counter()
    scores = score_chunks(model, _decoded_chunks(paths, load_one, args.workers), ids_pn,
                          mask_pn, batch_size=bs, mos_scale=args.mos_scale,
                          shared_prefix=args.shared_prefix,
                          normalize_type=args.normalize_type)
    elapsed = time.perf_counter() - t_start
    rows = [[path] + row for path, row in zip(videos, scores)]

    with open(args.out, "w", newline="") as f:
        w = csv.writer(f)
        if n_persp == 1:
            w.writerow(["video_name", "pred_score"])
        else:
            w.writerow(["video_name"] + [f"pred_score_{i + 1}" for i in range(n_persp)])
        w.writerows(rows)
    print(json.dumps({
        "metric": "videos_scored_per_sec",
        "value": round(len(videos) / max(elapsed, 1e-9), 3),
        "unit": "videos/sec",
        "n_videos": len(videos),
        "n_perspectives": n_persp,
        "perspective_scores_per_sec": round(len(videos) * n_persp / max(elapsed, 1e-9), 3),
        "out": args.out,
    }), flush=True)
    return rows


if __name__ == "__main__":
    main()
    sys.exit(0)
