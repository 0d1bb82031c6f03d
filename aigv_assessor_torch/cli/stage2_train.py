"""Stage-2 training (`aigv_assessor_tpu/cli/stage2_train.py`), the device
side: LoRA adapters on both towers and the `mlpscore` head trained on
L1(score, mos / 100), with a LoRA-only artifact written at the end.

- `build_training_model`: the stage-2 model on a device with its adapters,
  weights made from a seed, ready for `train/trainer.Trainer`.
- `prepare_batch`: uint8 frames -> normalized pixels, MOS scaled by
  `mos_scale` (0.01: the model scores in mos / 100).
- `train_steps`: a `Trainer` over a list of batches, one optimizer step per
  batch (split into `gradient_accumulation_steps` micro-batches), then the
  LoRA artifact `lora_weights.safetensors` in the output directory.

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
) -> AIGVAssessor:
    """The stage-2 model on `device` in fp32: the frozen weights from
    `init_random_(seed)` (the values `build_serving_model` draws from the same
    seed), the score head and the adapters as the JAX modules initialise
    them. `Trainer` then freezes it and casts the frozen part to the compute
    dtype. `config` carries the LoRA ranks (`use_backbone_lora`,
    `use_llm_lora`)."""
    if config.stage < 2:
        raise NotImplementedError(
            "stage-1 training (text loss) is not ported yet (ROADMAP.md, Queue 1)"
        )
    if precision.w8a8:
        raise NotImplementedError(
            "training over a W8A8 base is not ported yet (ROADMAP.md, Queue 1)"
        )
    with torch.device("meta"):
        model = AIGVAssessor(config, precision, grad_checkpoint=grad_checkpoint)
    model = init_random_(model.to_empty(device=device), seed)
    init_score_head_(model, seed + 1)
    return init_lora_(model, seed + 2)


def prepare_batch(
    model: AIGVAssessor,
    input_ids: torch.Tensor,  # [B, N]
    pixels_u8: torch.Tensor,  # [B, T, H, W, 3] uint8
    attention_mask: torch.Tensor,  # [B, N]
    mos: torch.Tensor,  # [B], in the dataset's range (0..100)
    mos_scale: float = MOS_SCALE,
) -> Dict[str, torch.Tensor]:
    """One batch as the trainer takes it, on the model's device."""
    device = next(model.parameters()).device
    pixels_u8 = pixels_u8.to(device)
    return {
        "input_ids": input_ids.to(device),
        "pixel_values": resize_normalize(
            pixels_u8, size=pixels_u8.shape[-2], dtype=model.precision.compute_dtype
        ),
        "attention_mask": attention_mask.to(device),
        "mos": mos.to(device=device, dtype=torch.float32) * mos_scale,
    }


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
    if trainer is None:
        trainer = Trainer(
            model, train_config, int(len(batches) * train_config.num_train_epochs)
        )
    accum = train_config.gradient_accumulation_steps

    def steps(epoch: int) -> Iterator[List[Dict[str, torch.Tensor]]]:
        for b in batches:
            yield microbatch(
                prepare_batch(model, b["input_ids"], b["pixels_u8"], b["attention_mask"],
                              b["mos"], mos_scale),
                accum,
            )

    trainer.train(steps)
    save_lora_weights(os.path.join(train_config.output_dir, LORA_FILE), model)
    return trainer
