"""Evaluation (`aigv_assessor_tpu/train/evaluate.py`): the teacher-forced
quality-word decode (stage 1), the score regression (stage 2), and the fused
multi-perspective stage-2 eval, writing the JAX package's CSV and metrics
files byte for byte.

- `word_to_level`: 'bad' -> 1 ... 'excellent' -> 5, else 0, checked in
  `QUALITY_LEVELS` order.
- `decode_answer_span`: the reference's decode slice: the answer's label
  count (without -100 and `<|im_end|>`) taken from the argmax predictions
  just before the sequence's end.
- `eval_forward` / `evaluate_batches`: the teacher-forced forward on each
  collated `Batch` under `torch.no_grad()` (argmax over the fp32 logits at
  every position but the last; stage 2 also `score`) -> rows
  [video_name, answer, output, mos, level(, pred_score)].
- `evaluate_perspectives`: P datasets over the same videos, paired by index;
  every video is decoded once (by a pool of reader threads, two batches
  ahead) and its frames and motion encoded once for all P prompts
  (`cli/score.score_batch`), the prompts' common prefix prefilled once per
  video where `compute_shared_prefix_len` allows it; scores are read back
  one batch late. `timing_out` gets `total_s`, `videos` and, past the first batch,
  `steady_s` / `steady_videos`.
- `save_perspective_results`, `correlation_metrics` (SRCC / PLCC / KRCC,
  scipy), `save_and_evaluate`: the CSV and the append-mode metrics TXT.
"""

from __future__ import annotations

import csv
import logging
import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np
import torch
from scipy.stats import kendalltau, pearsonr, spearmanr

from aigv_assessor_torch.data.constants import IGNORE_TOKEN_ID, QUALITY_LEVELS

logger = logging.getLogger(__name__)


def word_to_level(decoded: str) -> int:
    """'bad' -> 1 ... 'excellent' -> 5, 0 if none; the first word of
    `QUALITY_LEVELS` found wins, so 'bad' beats a later 'good'."""
    for word, level in QUALITY_LEVELS.items():
        if word in decoded:
            return level
    return 0


def decode_answer_span(
    tokenizer,
    pred_ids: np.ndarray,  # [S-1] argmax of the shifted logits of one sample
    shift_labels: np.ndarray,  # [S-1]
    real_len: int,  # the sample's unpadded length
    im_end_id: Optional[int],
) -> str:
    """With the unpadded sequence, `filtered` = the answer labels without
    -100 and `<|im_end|>`; the text decoded from the predictions at the
    len(filtered) positions before the last one."""
    labels = shift_labels[: real_len - 1]
    preds = pred_ids[: real_len - 1]
    filtered = [x for x in labels.tolist() if x != IGNORE_TOKEN_ID and x != im_end_id]
    n = len(filtered)
    if n == 0:
        return ""
    return tokenizer.decode(preds[-n - 1 : -1])


@torch.no_grad()
def eval_forward(model, batch, stage: int) -> Dict[str, torch.Tensor]:
    """The teacher-forced eval forward on one collated `Batch`, on the
    model's device: {'pred' [B, S-1] argmax of the logits at every position
    but the last, and at stage 2 'score' [B] fp32}."""
    device = next(model.parameters()).device
    out = model(
        torch.as_tensor(batch.input_ids, device=device).long(),
        torch.as_tensor(batch.pixel_values).to(device, model.precision.compute_dtype),
        torch.as_tensor(batch.attention_mask, device=device),
        with_logits=True,
    )
    ret = {"pred": out["logits"][:, :-1, :].argmax(dim=-1)}
    if stage >= 2:
        ret["score"] = out["score"]
    return ret


def evaluate_batches(
    model,
    batches: Iterable,
    tokenizer,
    stage: int = 1,
) -> List[List]:
    """`eval_forward` over collated `Batch`es -> reference-format rows
    [video_name, answer, output, mos, level(, pred_score)]."""
    im_end_id = tokenizer.convert_tokens_to_ids("<|im_end|>")
    model.eval()
    rows: List[List] = []
    for batch in batches:
        out = eval_forward(model, batch, stage)
        preds = out["pred"].cpu().numpy()
        scores = out["score"].float().cpu().numpy() if stage >= 2 else None
        shift_labels = batch.labels[:, 1:]
        real_lens = batch.attention_mask.sum(axis=1)
        for i in range(preds.shape[0]):
            decoded = decode_answer_span(
                tokenizer, preds[i], shift_labels[i], int(real_lens[i]), im_end_id
            )
            row = [batch.video_names[i], batch.answers[i], decoded, float(batch.mos[i]),
                   word_to_level(decoded)]
            if stage >= 2:
                row.append(float(scores[i]))
            rows.append(row)
    return rows


def evaluate_perspectives(
    model,
    datasets,  # P VideoQualityDatasets over the SAME videos (paired by index)
    batch_size: int = 8,
    workers: int = 4,
    timing_out: Optional[dict] = None,
):
    """Fused multi-perspective stage-2 evaluation: every video decoded and
    encoded once for all P perspectives, the P prompts scored against the
    shared embeddings (`AIGVAssessor.score_perspectives`). Returns P
    row-lists [video_name, answer, mos, pred_score]."""
    from aigv_assessor_torch.cli.score import compute_shared_prefix_len, score_batch

    p_count = len(datasets)
    n = len(datasets[0])
    if any(len(d) != n for d in datasets):
        raise ValueError("perspective datasets differ in size")
    for pi, d in enumerate(datasets):
        if not hasattr(d, "get_text_item"):
            raise ValueError(
                f"fused eval perspective {pi}: meta resolves to {type(d).__name__}; "
                "--fused_meta_paths requires each perspective meta to contain exactly ONE "
                "dataset entry (run multi-entry metas through the solo eval path)")
    texts = [[d.get_text_item(i) for i in range(n)] for d in datasets]
    for pi in range(1, p_count):
        for i in range(n):
            if texts[pi][i].video_name != texts[0][i].video_name:
                raise ValueError(
                    f"perspective {pi} sample {i} pairs a different video "
                    f"({texts[pi][i].video_name!r} vs {texts[0][i].video_name!r})")

    # batch at the longest real length, not the tokenizer's padding: the
    # shared-prefix pass puts the P suffixes on one sequence axis
    real_lens = [[int(t.attention_mask.sum()) for t in row] for row in texts]
    max_n = -(-max(max(r) for r in real_lens) // 8) * 8

    flat = [t.input_ids[: real_lens[pi][i]] for pi, row in enumerate(texts)
            for i, t in enumerate(row)]
    prefix_len = compute_shared_prefix_len(flat, model.config.img_context_token_id)
    uint8_ok = getattr(datasets[0], "supports_uint8_pixels", lambda: False)()
    normalize_type = getattr(datasets[0], "normalize_type", "imagenet")
    device = next(model.parameters()).device
    rows = [[] for _ in range(p_count)]
    idx_chunks = [list(range(i, min(i + batch_size, n))) for i in range(0, n, batch_size)]

    def pixels_for(i):
        # decode only, from the first perspective's dataset; uint8 where the
        # dataset allows it, normalized on the device
        if uint8_ok:
            return datasets[0].get_pixel_item_uint8(i)
        return datasets[0].get_pixel_item(i)

    model.eval()
    with ThreadPoolExecutor(workers) as pool:
        futures = {}

        def submit(ci):
            if ci < len(idx_chunks) and ci not in futures:
                futures[ci] = [pool.submit(pixels_for, i) for i in idx_chunks[ci]]

        submit(0)
        submit(1)
        batch_marks = []  # (wall time after batch ci was read back, videos done)
        done = 0
        t_start = time.perf_counter()
        pending = None  # read back one batch late: the device runs the next

        def flush(p):
            nonlocal done
            p_idxs, out = p
            scores = out.float().cpu().numpy()  # [b, P]
            done += len(p_idxs)
            batch_marks.append((time.perf_counter(), done))
            for bi, i in enumerate(p_idxs):
                for pi in range(p_count):
                    t = texts[pi][i]
                    rows[pi].append([t.video_name, t.answer, float(t.mos),
                                     float(scores[bi, pi])])

        for ci, idxs in enumerate(idx_chunks):
            pixels = [f.result() for f in futures.pop(ci)]
            submit(ci + 2)
            b = len(idxs)
            ids = np.zeros((b, p_count, max_n), np.int64)
            mask = np.zeros((b, p_count, max_n), bool)
            for bi, i in enumerate(idxs):
                for pi in range(p_count):
                    ln = real_lens[pi][i]
                    ids[bi, pi, :ln] = texts[pi][i].input_ids[:ln]
                    mask[bi, pi, :ln] = True
            out = score_batch(
                model, torch.as_tensor(ids, device=device),
                torch.as_tensor(np.stack(pixels)).to(device),
                torch.as_tensor(mask, device=device), prefix_len or None, normalize_type,
            )
            if pending is not None:
                flush(pending)
            pending = (idxs, out)
        if pending is not None:
            flush(pending)
    if timing_out is not None and batch_marks:
        timing_out["total_s"] = batch_marks[-1][0] - t_start
        timing_out["videos"] = batch_marks[-1][1]
        if len(batch_marks) > 1:
            # steady state: without the first batch, which carries the warm-up
            t1, v1 = batch_marks[0]
            timing_out["steady_s"] = batch_marks[-1][0] - t1
            timing_out["steady_videos"] = batch_marks[-1][1] - v1
    return rows


def save_perspective_results(
    rows,  # [video_name, answer, mos, pred_score]
    output_file: str,
    metrics_file: str,
    write: bool = True,
):
    """One perspective of the fused eval: the pred_score CSV and the stage-2
    score-correlation block of the metrics TXT (appended); with `write`
    False only the metrics are computed (a rank other than the primary)."""
    corr = correlation_metrics([r[2] for r in rows], [r[3] for r in rows])
    if not write:
        return {f"{k}_score": v for k, v in corr.items()}
    os.makedirs(os.path.dirname(os.path.abspath(output_file)), exist_ok=True)
    with open(output_file, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["video_name", "answer", "mos", "pred_score"])
        w.writerows(rows)
    with open(metrics_file, "a") as f:
        f.writelines([
            f"SRCC_score: {corr['SRCC']}\n",
            f"PLCC_score: {corr['PLCC']}\n",
            f"KRCC_score: {corr['KRCC']}\n",
        ])
    return {f"{k}_score": v for k, v in corr.items()}


def correlation_metrics(x: Sequence[float], y: Sequence[float]) -> Dict[str, float]:
    srcc, _ = spearmanr(x, y)
    plcc, _ = pearsonr(x, y)
    krcc, _ = kendalltau(x, y)
    return {"SRCC": float(srcc), "PLCC": float(plcc), "KRCC": float(krcc)}


def save_and_evaluate(
    rows: List[List],
    output_file: str = "results.csv",
    metrics_file: str = "metrics.txt",
    stage: int = 1,
    write: bool = True,
) -> Dict[str, float]:
    """The CSV (columns video_name, answer, output, mos, level, and at stage
    2 pred_score) and the append-mode metrics TXT: Accuracy (the output a
    substring of the answer), SRCC / PLCC / KRCC of the levels against mos,
    and at stage 2 the same of pred_score. With `write` False the metrics
    are computed and no file is written (a rank other than the primary)."""
    columns = ["video_name", "answer", "output", "mos", "level"]
    if stage >= 2:
        columns.append("pred_score")
    if write:
        os.makedirs(os.path.dirname(os.path.abspath(output_file)), exist_ok=True)
        with open(output_file, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(columns)
            w.writerows(rows)
        logger.info("results saved to %s", output_file)

    total = len(rows)
    right = sum(1 for r in rows if r[2] in r[1])
    accuracy = right / max(total, 1)
    mos_values = [r[3] for r in rows]
    metrics = {"accuracy": accuracy, **correlation_metrics(mos_values, [r[4] for r in rows])}
    lines = [
        f"Accuracy: {accuracy}\n",
        f"SRCC: {metrics['SRCC']}\n",
        f"PLCC: {metrics['PLCC']}\n",
        f"KRCC: {metrics['KRCC']}\n",
    ]
    if stage >= 2:
        score_corr = correlation_metrics(mos_values, [r[5] for r in rows])
        metrics.update({f"{k}_score": v for k, v in score_corr.items()})
        lines += [
            f"SRCC_score: {score_corr['SRCC']}\n",
            f"PLCC_score: {score_corr['PLCC']}\n",
            f"KRCC_score: {score_corr['KRCC']}\n",
        ]
    if write:
        with open(metrics_file, "a") as f:
            f.writelines(lines)
    for k, v in metrics.items():
        logger.info("%s: %s", k, v)
    return metrics
