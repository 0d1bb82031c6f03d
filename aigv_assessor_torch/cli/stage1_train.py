"""Stage-1 training (`aigv_assessor_tpu/cli/stage1_train.py`), the device
side: the spatiotemporal projectors (`mlp1`, `motion_mlp`) trained on the
shifted text cross-entropy of the assistant's answer (`labels` from
`data/preprocess.preprocess_internlm`), with the ViT and the LLM frozen
(`freeze_backbone`, `freeze_llm`), then the trained weights written as one
safetensors file keyed by their JAX paths.

- `build_training_model`: the stage-1 model on a device, weights made from a
  seed, through `cli/stage2_train.build_training_model`; no score
  head, as in JAX.
- `prepare_batch`: uint8 frames -> normalized pixels, with the labels.
- `train_steps`: a `Trainer` over a list of batches, one optimizer step per
  batch, `train_log.jsonl` and `TRAINABLE_FILE` in the output directory.

The frozen ViT sits before `mlp1`, so autograd runs no backward through it:
its attention runs the forward without logsumexp. The LLM's backward runs
because its input embeddings depend on `mlp1` and `motion_mlp`.

The host side of the JAX CLI (datasets, loader, evaluation to CSV, the best
checkpoint by quality-level accuracy) is not ported yet (ROADMAP.md, Queue 1
item 5): callers hand in token ids, labels and uint8 frames.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Sequence

import torch

from aigv_assessor_torch.cli import stage2_train
from aigv_assessor_torch.core.config import AssessorConfig
from aigv_assessor_torch.models.assessor import AIGVAssessor
from aigv_assessor_torch.train.checkpoint import save_trainable_weights
from aigv_assessor_torch.train.trainer import TrainConfig, Trainer

STAGE = 1
MOS_SCALE = 1.0
TRAINABLE_FILE = "trainable_weights.safetensors"


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
