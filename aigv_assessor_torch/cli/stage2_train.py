"""Stage-2 training (`aigv_assessor_tpu/cli/stage2_train.py`), the device
side: LoRA adapters on both towers and the `mlpscore` head trained on
L1(score, mos / 100), with a LoRA-only artifact written at the end.

- `build_training_model`: the stage-2 (or, shared with
  `cli/stage1_train.py`, stage-1) model on a device with its adapters,
  weights made from a seed, ready for `train/trainer.Trainer`.
- `prepare_batch`: uint8 frames -> normalized pixels, MOS scaled by
  `mos_scale` (0.01: the model scores in mos / 100).
- `train_steps`: a `Trainer` over a list of batches, one optimizer step per
  batch (split into `gradient_accumulation_steps` micro-batches; the loop is
  `run_steps`, which stage 1 shares), then the LoRA artifact
  `lora_weights.safetensors` in the output directory.

The host side of the JAX CLI (dataset and sampler, tokenizer, video decode,
the flags, evaluation to CSV) is not ported yet (ROADMAP.md, Queue 1):
callers hand in token ids, uint8 frames and MOS values. Weights come from a
seed until a checkpoint can be loaded.
"""

from __future__ import annotations

import os
from typing import Dict, Iterator, List, Optional, Sequence

import torch

from aigv_assessor_torch.core.config import AssessorConfig
from aigv_assessor_torch.core.precision import Precision
from aigv_assessor_torch.models.assessor import AIGVAssessor
from aigv_assessor_torch.models.loading import init_lora_, init_random_, init_score_head_
from aigv_assessor_torch.ops.preprocess import resize_normalize
from aigv_assessor_torch.train.checkpoint import save_lora_weights
from aigv_assessor_torch.train.freeze import apply_freeze_, cast_frozen_
from aigv_assessor_torch.train.trainer import TrainConfig, Trainer, microbatch

MOS_SCALE = 0.01
LORA_FILE = "lora_weights.safetensors"


def build_training_model(
    config: AssessorConfig,
    *,
    device: torch.device | str,
    precision: Precision = Precision(),
    seed: int = 0,
    grad_checkpoint: bool = True,
    train_config: TrainConfig = TrainConfig(),
) -> AIGVAssessor:
    """The stage-1 or stage-2 model on `device`: the frozen weights from
    `init_random_(seed)` (the values `build_serving_model` draws from the same
    seed), the score head (stage 2) and the adapters as the JAX modules
    initialise them. `config` carries the stage and the LoRA ranks
    (`use_backbone_lora`, `use_llm_lora`).

    What `train_config`'s freeze flags leave trainable is fp32. When it holds
    the frozen part in bf16 (`frozen_bf16` under a bf16 compute dtype, what
    `Trainer` then does anyway) the frozen weights are built in bf16 from
    the start, each drawn in fp32 and rounded, so no fp32 copy of the model
    is ever held (InternVL2-26B: 47.5 GiB in bf16, 95 GiB in fp32)."""
    if precision.w8a8:
        raise NotImplementedError(
            "training over a W8A8 base is not ported yet (ROADMAP.md, Queue 1)"
        )
    with torch.device("meta"):
        model = AIGVAssessor(config, precision, grad_checkpoint=grad_checkpoint)
    if train_config.frozen_bf16 and precision.compute_dtype == torch.bfloat16:
        apply_freeze_(model, config.stage, freeze_backbone=train_config.freeze_backbone,
                      freeze_llm=train_config.freeze_llm, freeze_mlp=train_config.freeze_mlp,
                      unfreeze_lm_head=train_config.unfreeze_lm_head)
        cast_frozen_(model, torch.bfloat16)
    model = init_random_(model.to_empty(device=device), seed)
    if config.stage >= 2:
        init_score_head_(model, seed + 1)
    return init_lora_(model, seed + 2)


def prepare_batch(
    model: AIGVAssessor,
    input_ids: torch.Tensor,  # [B, N]
    pixels_u8: torch.Tensor,  # [B, T, H, W, 3] uint8
    attention_mask: torch.Tensor,  # [B, N]
    mos: Optional[torch.Tensor] = None,  # [B], in the dataset's range (0..100)
    mos_scale: float = MOS_SCALE,
    labels: Optional[torch.Tensor] = None,  # [B, N], -100 = ignored
) -> Dict[str, torch.Tensor]:
    """One batch as the trainer takes it, on the model's device."""
    device = next(model.parameters()).device
    pixels_u8 = pixels_u8.to(device)
    batch = {
        "input_ids": input_ids.to(device),
        "pixel_values": resize_normalize(
            pixels_u8, size=pixels_u8.shape[-2], dtype=model.precision.compute_dtype
        ),
        "attention_mask": attention_mask.to(device),
    }
    if mos is not None:
        batch["mos"] = mos.to(device=device, dtype=torch.float32) * mos_scale
    if labels is not None:
        batch["labels"] = labels.to(device)
    return batch


def run_steps(
    model: AIGVAssessor,
    batches: Sequence[Dict[str, torch.Tensor]],
    train_config: TrainConfig,
    *,
    mos_scale: float,
    trainer: Optional[Trainer] = None,
) -> Trainer:
    """The loop both stages' `train_steps` share: one optimizer step per
    batch of {input_ids, pixels_u8, attention_mask, and mos and / or labels},
    `ceil(train_config.num_train_epochs)` passes, each batch split into
    `train_config.gradient_accumulation_steps` micro-batches."""
    if trainer is None:
        trainer = Trainer(
            model, train_config, int(len(batches) * train_config.num_train_epochs)
        )
    accum = train_config.gradient_accumulation_steps

    def steps(epoch: int) -> Iterator[List[Dict[str, torch.Tensor]]]:
        for b in batches:
            yield microbatch(
                prepare_batch(model, b["input_ids"], b["pixels_u8"], b["attention_mask"],
                              b.get("mos"), mos_scale, b.get("labels")),
                accum,
            )

    trainer.train(steps)
    return trainer


def train_steps(
    model: AIGVAssessor,
    batches: Sequence[Dict[str, torch.Tensor]],
    train_config: TrainConfig,
    *,
    mos_scale: float = MOS_SCALE,
    trainer: Optional[Trainer] = None,
) -> Trainer:
    """Train over `batches` of {input_ids, pixels_u8, attention_mask, mos},
    one epoch's data: one optimizer step per batch and
    `ceil(train_config.num_train_epochs)` passes over them, then write the
    LoRA artifact. Each batch is split into
    `train_config.gradient_accumulation_steps` micro-batches. Losses go to
    `<output_dir>/train_log.jsonl`. Pass `trainer` to continue a run."""
    trainer = run_steps(model, batches, train_config, mos_scale=mos_scale, trainer=trainer)
    save_lora_weights(os.path.join(train_config.output_dir, LORA_FILE), model)
    return trainer
