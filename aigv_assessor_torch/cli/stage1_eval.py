"""Stage-1 evaluation (`aigv_assessor_tpu/cli/stage1_eval.py`): the
teacher-forced forward over the eval annotation of `--meta_path` (meta key
'annotation'), the argmax decode at the answer's positions, quality word ->
level, and the CSV and Accuracy / SRCC / PLCC / KRCC metrics TXT.

    python -m aigv_assessor_torch.cli.stage1_eval --meta_path META.json \
        --model_scale 2b --eval_batch_size 4 --output_dir out

Flags as the JAX CLI's (`cli/args.py`), plus `--device` (default `cuda`;
`--device cpu --bf16 False` on a machine without a card). Batched
(`--eval_batch_size`, default 8) where the reference loops one sample at a
time; GIFs are read at 10 fps, mos as the annotation gives it.

Launched on several cards (`python -m torch.distributed.run
--nproc_per_node N -m aigv_assessor_torch.cli.stage1_eval ...`), every rank
evaluates the whole set with the whole model, as JAX's processes do after
its `init_dist`, and the primary alone writes the files (JAX writes them
from every process).
"""

from __future__ import annotations

import os
import sys

from aigv_assessor_torch.cli.args import parse_args
from aigv_assessor_torch.cli.common import build_model_and_tokenizer
from aigv_assessor_torch.core.dist import init_dist, is_primary
from aigv_assessor_torch.data.dataset import build_datasets
from aigv_assessor_torch.data.loader import DataLoader
from aigv_assessor_torch.data.sampler import ShardedBatchSampler
from aigv_assessor_torch.train.evaluate import evaluate_batches, save_and_evaluate
from aigv_assessor_torch.utils.logging_utils import setup_logging

STAGE = 1
MOS_SCALE = 1.0


def main(argv=None, stage=STAGE, mos_scale=MOS_SCALE):
    """-> the metrics dict; writes `<output_dir>/<output_file>` and appends
    to `<output_dir>/<metrics_file>`."""
    args = parse_args(f"AIGV-Assessor stage-{stage} evaluation", argv)
    init_dist(device=args.device)
    setup_logging()
    config, model, tokenizer = build_model_and_tokenizer(args, stage)
    eval_ds = build_datasets(
        args.meta_path,
        tokenizer,
        config,
        split="eval",
        num_segments=args.num_segments,
        group_by_length=args.group_by_length,
        mos_scale=mos_scale,
        normalize_type=args.normalize_type,
        gif_fps=10.0 if stage == 1 else 1.0,
    )
    sampler = ShardedBatchSampler(len(eval_ds), global_batch_size=args.eval_batch_size,
                                  shuffle=False, drop_last=False)
    loader = DataLoader(eval_ds, sampler, num_workers=args.dataloader_num_workers)
    rows = evaluate_batches(model, loader, tokenizer, stage=stage)
    os.makedirs(args.output_dir, exist_ok=True)
    return save_and_evaluate(
        rows,
        output_file=os.path.join(args.output_dir, args.output_file),
        metrics_file=os.path.join(args.output_dir, args.metrics_file),
        stage=stage,
        write=is_primary(),
    )


if __name__ == "__main__":
    main()
    sys.exit(0)
