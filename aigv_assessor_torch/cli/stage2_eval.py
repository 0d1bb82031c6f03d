"""Stage-2 evaluation (`aigv_assessor_tpu/cli/stage2_eval.py`): stage-1
eval plus the continuous score per sample, a `pred_score` CSV column and the
SRCC / PLCC / KRCC block over it. mos is kept as the annotation gives it
(the reference divides by 100 only in stage-2 training); GIFs at 1 fps.

    python -m aigv_assessor_torch.cli.stage2_eval --meta_path META.json \
        --model_scale 2b --eval_batch_size 4 --output_dir out \
        [--fused_meta_paths META2.json ...] [--eval_w8a8 True]

- `main`: without `--fused_meta_paths`, `cli/stage1_eval.main` at stage 2.
- `fused_main`: `--meta_path` and each `--fused_meta_paths` meta are one
  perspective over the same videos; every video is decoded and encoded once
  for all of them (`train/evaluate.evaluate_perspectives`), optionally at
  the W8A8 serving precision (`--eval_w8a8`). It prints one `fused eval:`
  line (videos/s with decode included, first batch and steady state) and
  writes `results_p{i}.csv` / `metrics_p{i}.txt` per perspective.
"""

from __future__ import annotations

import logging
import os
import sys

from aigv_assessor_torch.cli import stage1_eval
from aigv_assessor_torch.cli.args import parse_args

logger = logging.getLogger(__name__)


def main(argv=None):
    args = parse_args("AIGV-Assessor stage-2 evaluation", argv)
    if args.fused_meta_paths:
        return fused_main(args)
    return stage1_eval.main(argv, stage=2, mos_scale=1.0)


def fused_main(args):
    """The fused multi-perspective eval -> {'p1': metrics, 'p2': ...}; every
    rank of a multi-process run evaluates, the primary writes."""
    from aigv_assessor_torch.cli.common import build_model_and_tokenizer
    from aigv_assessor_torch.core.dist import init_dist, is_primary
    from aigv_assessor_torch.utils.logging_utils import setup_logging

    init_dist(device=args.device)
    setup_logging()
    from aigv_assessor_torch.data.dataset import build_datasets
    from aigv_assessor_torch.train.evaluate import evaluate_perspectives, save_perspective_results

    config, model, tokenizer = build_model_and_tokenizer(args, stage=2, w8a8=args.eval_w8a8)
    metas = [args.meta_path] + list(args.fused_meta_paths)
    datasets = [
        build_datasets(m, tokenizer, config, split="eval", num_segments=args.num_segments,
                       group_by_length=args.group_by_length, mos_scale=1.0, gif_fps=1.0,
                       normalize_type=args.normalize_type)
        for m in metas
    ]
    timing = {}
    rows = evaluate_perspectives(model, datasets, batch_size=args.eval_batch_size,
                                 workers=max(1, args.dataloader_num_workers),
                                 timing_out=timing)
    n_videos = len(rows[0]) if rows else 0
    if timing:
        dt = timing["total_s"]
        msg = (
            "fused eval: %d videos x %d perspectives in %.2f s "
            "(%.2f videos/s, %.2f persp-evals/s incl. first-batch warm-up"
            % (n_videos, len(rows), dt, n_videos / dt, n_videos * len(rows) / dt)
        )
        if timing.get("steady_s", 0) > 0:
            sv, ss = timing["steady_videos"], timing["steady_s"]
            msg += "; steady-state %.2f videos/s, %.2f persp-evals/s" % (
                sv / ss, sv * len(rows) / ss)
        print(msg + ")", flush=True)
    os.makedirs(args.output_dir, exist_ok=True)
    all_metrics = {}
    for i, r in enumerate(rows):
        m = save_perspective_results(
            r,
            output_file=os.path.join(args.output_dir, f"results_p{i + 1}.csv"),
            metrics_file=os.path.join(args.output_dir, f"metrics_p{i + 1}.txt"),
            write=is_primary(),
        )
        logger.info("perspective %d (%s): %s", i + 1, metas[i], m)
        all_metrics[f"p{i + 1}"] = m
    return all_metrics


if __name__ == "__main__":
    main()
    sys.exit(0)
