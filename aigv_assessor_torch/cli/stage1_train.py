"""Stage-1 training (`aigv_assessor_tpu/cli/stage1_train.py`): the
spatiotemporal projectors (`mlp1`, `motion_mlp`) trained on the shifted
text cross-entropy of the assistant's answer, with the ViT and the LLM
frozen (`freeze_backbone`, `freeze_llm`), evaluated periodically by
quality-level accuracy, the best checkpoint kept.

    python -m aigv_assessor_torch.cli.stage1_train --meta_path META.json \
        --model_scale 2b --do_train True --per_device_train_batch_size 2 \
        --evaluation_strategy steps --eval_steps 60 --output_dir out

Flags as the JAX CLI's (`cli/args.py`), plus `--device` (default `cuda`;
`--device cpu --bf16 False` on a machine without a card).

- `main`: the JAX CLI's `main` step for step: the model
  (`build_training_model`, weights from `--model_name_or_path` or
  `--seed`), the train and test datasets of the meta file, the
  length-grouped sampler and the threaded loader, each collated batch on
  the device and split into `--gradient_accumulation_steps` micro-batches,
  evaluation every `--eval_steps` to `<output_dir>/<output_file>` and
  `<metrics_file>` (`run_eval`), checkpoints under
  `<output_dir>/checkpoints` (the best by `best_metric`),
  `--resume_from_checkpoint`, and at stage 1 the trained projectors as
  `TRAINABLE_FILE`. `cli/stage2_train.main` is this at stage 2.
  Launched on N cards (`python -m torch.distributed.run --nproc_per_node N
  -m aigv_assessor_torch.cli.stage1_train ... --mesh_fsdp N`), each rank
  loads its shard of every global batch of `--per_device_train_batch_size`
  x data x fsdp rows, keyed by its data rank (the ranks of one tensor group
  read the same rows), the trainer splits the towers over `--mesh_tensor`
  and runs FSDP2 over the `--mesh_*` layout (`train/trainer.py`), every
  rank evaluates, and the primary alone writes the log, the eval files, the
  artifacts and the checkpoints.
- `build_training_model`: the stage-1 model on a device, through
  `cli/stage2_train.build_training_model`; no score head, as in JAX.
- `prepare_batch`: uint8 frames -> normalized pixels, with the labels.
- `train_steps`: a `Trainer` over a list of batches the caller made, one
  optimizer step per batch, `train_log.jsonl` and `TRAINABLE_FILE` in the
  output directory.

A resumed run restores the trainer's state (trainable weights, Adam's
moments, step, generator) and runs the schedule from epoch 0, as JAX's
does: no consumed batch is skipped.

The frozen ViT sits before `mlp1`, so autograd runs no backward through it:
its attention runs the forward without logsumexp. The LLM's backward runs
because its input embeddings depend on `mlp1` and `motion_mlp`.
"""

from __future__ import annotations

import logging
import os
import sys
from typing import Dict, Optional, Sequence

import torch

from aigv_assessor_torch.cli import common, stage2_train
from aigv_assessor_torch.cli.args import parse_args
from aigv_assessor_torch.core.config import AssessorConfig
from aigv_assessor_torch.core.dist import init_dist, is_primary
from aigv_assessor_torch.core.mesh import data_coords
from aigv_assessor_torch.core.precision import Precision
from aigv_assessor_torch.data.dataset import build_datasets
from aigv_assessor_torch.data.loader import DataLoader
from aigv_assessor_torch.data.sampler import LengthGroupedSampler, ShardedBatchSampler
from aigv_assessor_torch.models.assessor import AIGVAssessor
from aigv_assessor_torch.train.checkpoint import CheckpointManager, save_trainable_weights
from aigv_assessor_torch.train.evaluate import evaluate_batches, save_and_evaluate
from aigv_assessor_torch.train.trainer import TrainConfig, Trainer, microbatch
from aigv_assessor_torch.utils.logging_utils import setup_logging

logger = logging.getLogger(__name__)

STAGE = 1
BEST_METRIC = "accuracy"  # the reference's stage-1 criterion (stage1_train.py:286)
MOS_SCALE = 1.0
TRAINABLE_FILE = "trainable_weights.safetensors"
# the reference's estimated length of every sample for the length-grouped
# sampler (train_sampler_patch.py, stage1_train.py:437)
EST_SAMPLE_LEN = 461


def main(argv=None, stage=STAGE, best_metric=BEST_METRIC, mos_scale=MOS_SCALE, on_best=None):
    """Train from `--meta_path` -> the `Trainer`. `on_best(args)`, if given,
    makes the callback the trainer calls with (model, step) on every new
    best `best_metric`."""
    args = parse_args(f"AIGV-Assessor stage-{stage} training", argv)
    init_dist(device=args.device)
    setup_logging()
    mesh = common.mesh_from_args(args)
    mesh_config = common.mesh_config_from_args(args)
    n_dp = mesh_config.data * mesh_config.fsdp
    config, tokenizer = common.config_and_tokenizer(args, stage)

    data_kw = dict(num_segments=args.num_segments, group_by_length=args.group_by_length,
                   mos_scale=mos_scale, normalize_type=args.normalize_type,
                   gif_fps=10.0 if stage == 1 else 1.0)
    train_ds = build_datasets(args.meta_path, tokenizer, config, split="train", **data_kw)
    try:
        eval_ds = build_datasets(args.meta_path, tokenizer, config, split="test", **data_kw)
    except ValueError:
        eval_ds = None

    batch_size = args.per_device_train_batch_size
    global_bs = batch_size * n_dp
    accum = args.gradient_accumulation_steps
    if len(train_ds) < global_bs * accum:
        logger.warning("dataset (%d samples) smaller than one global batch (%d x %d accum): "
                       "no training steps will run; shrink the mesh or batch", len(train_ds),
                       global_bs, accum)
    steps_per_epoch = max(len(train_ds) // (global_bs * accum), 1)
    total_steps = int(steps_per_epoch * args.num_train_epochs)

    tcfg = TrainConfig(
        output_dir=args.output_dir,
        learning_rate=args.learning_rate,
        weight_decay=args.weight_decay,
        warmup_ratio=args.warmup_ratio,
        lr_scheduler_type=args.lr_scheduler_type,
        num_train_epochs=args.num_train_epochs,
        per_device_train_batch_size=batch_size,
        gradient_accumulation_steps=accum,
        logging_steps=args.logging_steps,
        save_steps=args.save_steps,
        save_total_limit=args.save_total_limit,
        eval_steps=args.eval_steps if args.evaluation_strategy != "no" else 0,
        seed=args.seed,
        grad_checkpoint=args.grad_checkpoint,
        freeze_backbone=args.freeze_backbone,
        freeze_llm=args.freeze_llm,
        freeze_mlp=args.freeze_mlp,
        unfreeze_lm_head=args.unfreeze_lm_head,
        max_seq_length=args.max_seq_length,
        bf16=args.bf16,
        resume_from_checkpoint=args.resume_from_checkpoint,
        output_file=args.output_file,
        metrics_file=args.metrics_file,
    )
    precision = Precision() if args.bf16 else Precision.fp32()
    model = stage2_train.build_training_model(
        config, device=args.device, precision=precision, seed=args.seed,
        grad_checkpoint=args.grad_checkpoint, train_config=tcfg,
        weights=common.model_weights(args, config),
        vit_remat_policy=args.vit_remat_policy or None,
        grafts=common.graft_weights(args, config))
    device = next(model.parameters()).device
    os.makedirs(args.output_dir, exist_ok=True)

    def eval_fn(model, step):
        rows = run_eval(model, eval_ds, tokenizer, args, stage)
        return save_and_evaluate(
            rows,
            output_file=os.path.join(args.output_dir, args.output_file),
            metrics_file=os.path.join(args.output_dir, args.metrics_file),
            stage=stage,
            write=is_primary(),
        )

    trainer = Trainer(
        model,
        tcfg,
        total_steps,
        eval_fn=eval_fn if eval_ds is not None else None,
        best_metric_key=best_metric,
        checkpoint_manager=CheckpointManager(os.path.join(args.output_dir, "checkpoints"),
                                             save_total_limit=args.save_total_limit),
        on_best=on_best(args) if callable(on_best) else None,
        mesh=mesh,
    )
    if args.resume_from_checkpoint:
        CheckpointManager(args.resume_from_checkpoint).restore(trainer)
        logger.info("resumed from %s at step %d", args.resume_from_checkpoint, trainer.step)

    def to_device(arrays):
        """A collated batch on the device: ids and labels int64, pixels (the
        collator's normalized fp32) in the compute dtype."""
        return {
            "input_ids": torch.as_tensor(arrays["input_ids"], device=device).long(),
            "labels": torch.as_tensor(arrays["labels"], device=device).long(),
            "attention_mask": torch.as_tensor(arrays["attention_mask"], device=device),
            "pixel_values": torch.as_tensor(arrays["pixel_values"]).to(
                device, precision.compute_dtype),
            "mos": torch.as_tensor(arrays["mos"], device=device),
        }

    def data_iter(epoch):
        sampler = None
        if args.group_by_length and hasattr(train_ds, "raw_data"):
            sampler = LengthGroupedSampler([EST_SAMPLE_LEN] * len(train_ds), batch_size, n_dp,
                                           seed=args.seed)
        # each data rank loads its contiguous shard of every global batch
        data_rank, data_size = data_coords(mesh)
        batches = ShardedBatchSampler(sampler if sampler is not None else len(train_ds),
                                      global_batch_size=global_bs * accum,
                                      num_processes=data_size,
                                      process_index=data_rank, seed=args.seed)
        batches.set_epoch(epoch)
        loader = DataLoader(train_ds, batches,
                            pad_to=args.max_seq_length if not args.group_by_length else None,
                            num_workers=args.dataloader_num_workers)
        for batch in loader:
            yield microbatch(to_device(batch.arrays()), accum)

    if args.do_train:
        trainer.train(data_iter)
        if stage == STAGE:
            save_trainable_weights(os.path.join(args.output_dir, TRAINABLE_FILE), model,
                                   trainer.trainable)
    else:
        trainer.maybe_eval(0)
    return trainer


def run_eval(model, eval_ds, tokenizer, args, stage):
    """The teacher-forced eval over `eval_ds`, `--eval_batch_size` at a time,
    in order -> the rows `train/evaluate.save_and_evaluate` takes."""
    sampler = ShardedBatchSampler(len(eval_ds), global_batch_size=args.eval_batch_size,
                                  shuffle=False, drop_last=False)
    loader = DataLoader(eval_ds, sampler, pad_to=None, num_workers=args.dataloader_num_workers)
    return evaluate_batches(model, loader, tokenizer, stage=stage)


def build_training_model(config: AssessorConfig, **kw) -> AIGVAssessor:
    """The stage-1 model: `cli/stage2_train.build_training_model` at
    `stage=1` (keywords as there)."""
    return stage2_train.build_training_model(config.replace(stage=STAGE), **kw)


def prepare_batch(
    model: AIGVAssessor,
    input_ids: torch.Tensor,  # [B, N]
    pixels_u8: torch.Tensor,  # [B, T, H, W, 3] uint8
    attention_mask: torch.Tensor,  # [B, N]
    labels: torch.Tensor,  # [B, N], -100 = ignored
) -> Dict[str, torch.Tensor]:
    """One batch as the trainer takes it, on the model's device."""
    return stage2_train.prepare_batch(model, input_ids, pixels_u8, attention_mask,
                                      mos_scale=MOS_SCALE, labels=labels)


def train_steps(
    model: AIGVAssessor,
    batches: Sequence[Dict[str, torch.Tensor]],
    train_config: TrainConfig,
    *,
    trainer: Optional[Trainer] = None,
) -> Trainer:
    """Train over `batches` of {input_ids, pixels_u8, attention_mask,
    labels}: one optimizer step per batch (split into
    `gradient_accumulation_steps` micro-batches),
    `ceil(train_config.num_train_epochs)` passes, losses to
    `<output_dir>/train_log.jsonl`, then the trainable parameters to
    `<output_dir>/TRAINABLE_FILE`. Pass `trainer` to continue a run."""
    trainer = stage2_train.run_steps(model, batches, train_config, mos_scale=MOS_SCALE,
                                     trainer=trainer)
    save_trainable_weights(os.path.join(train_config.output_dir, TRAINABLE_FILE), model,
                           trainer.trainable)
    return trainer


if __name__ == "__main__":
    main()
    sys.exit(0)
