"""Which parameters train (`aigv_assessor_tpu/train/freeze.py`).

The JAX package builds a mask tree and splits the parameters in two; here
the same predicate, over the port's parameter names, sets `requires_grad`,
so autograd computes no weight gradient of a frozen layer and the optimizer
holds no state for it.

- stage 2: everything frozen except the LoRA adapter leaves and `mlpscore`;
- stage 1: `mlp1` and `motion_mlp` train unless `freeze_mlp`, the towers
  follow `freeze_backbone` / `freeze_llm`, and `unfreeze_lm_head` frees the
  LLM's embeddings and head under a frozen LLM;
- SlowFast is always frozen.
"""

from __future__ import annotations

from typing import Dict, List

import torch
from torch import nn

from aigv_assessor_torch.models.lora import is_lora_param


def is_trainable(
    name: str,
    stage: int,
    freeze_backbone: bool = True,
    freeze_llm: bool = True,
    freeze_mlp: bool = False,
    unfreeze_lm_head: bool = False,
) -> bool:
    """The JAX `make_trainable_mask` predicate on a dotted parameter name."""
    top = name.split(".", 1)[0]
    if top == "slowfast_model":
        return False
    if is_lora_param(name):
        return True
    if stage >= 2:
        return top == "mlpscore"
    if top in ("mlp1", "motion_mlp"):
        return not freeze_mlp
    if top == "vision_model":
        return not freeze_backbone
    if top == "language_model":
        if unfreeze_lm_head and name.split(".")[1] in ("output", "tok_embeddings"):
            return True
        return not freeze_llm
    return False


def trainable_names(model: nn.Module, stage: int, **flags) -> List[str]:
    """Names of the parameters that train, in `named_parameters` order."""
    return [n for n, _ in model.named_parameters() if is_trainable(n, stage, **flags)]


def apply_freeze_(model: nn.Module, stage: int, **flags) -> List[str]:
    """Set every parameter's `requires_grad` from the predicate; returns the
    trainable names."""
    names = []
    for n, p in model.named_parameters():
        on = is_trainable(n, stage, **flags)
        p.requires_grad_(on)
        if on:
            names.append(n)
    return names


@torch.no_grad()
def cast_frozen_(model: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Cast everything but the trainable parameters to `dtype` (the JAX
    trainer's `frozen_bf16`): the frozen weights are read in the compute
    dtype anyway, and the trainable ones stay fp32 masters that the forward
    casts. Call after `apply_freeze_`."""
    masters = {n: p.data for n, p in model.named_parameters() if p.requires_grad}
    model.to(dtype)
    for n, p in model.named_parameters():
        if n in masters:
            p.data = masters[n]
    return model


def count_params(model: nn.Module) -> Dict[str, int]:
    """{'total', 'trainable'} element counts over parameters and buffers
    (the JAX tree counts the frozen batch-norm statistics too)."""
    tensors = list(model.parameters()) + list(model.buffers())
    return {
        "total": sum(t.numel() for t in tensors),
        "trainable": sum(p.numel() for p in model.parameters() if p.requires_grad),
    }
