"""Layer-wise learning-rate decay (`aigv_assessor_tpu/train/layer_decay.py`).

Per-parameter learning-rate multipliers `rate ** (n_layers + 1 - layer_id)`
for the ViT and the LLM, the LLM's also times `llm_lr_scale`. layer_id is 0
for a tower's embeddings, i + 1 for its layer i, and n_layers + 1 for
whatever else the tower holds; parameters outside the towers get 1. Rates
left None come from the environment (VIT_LAYER_DECAY_RATE,
QLLAMA_LAYER_DECAY_RATE, QLLAMA_LR_SCALE), default 1. The JAX package scales
the optimizer's updates by them; the trainer here scales each parameter
group's learning rate, which is the same thing for AdamW.
"""

from __future__ import annotations

import os
import re
from typing import Dict, Optional

from torch import nn

_ENV = {
    "vit_decay_rate": "VIT_LAYER_DECAY_RATE",
    "llm_decay_rate": "QLLAMA_LAYER_DECAY_RATE",
    "llm_lr_scale": "QLLAMA_LR_SCALE",
}


def layer_decay_requested(*rates: Optional[float]) -> bool:
    """True if a rate is given or one of the environment variables is set."""
    return any(r is not None for r in rates) or any(os.environ.get(v) for v in _ENV.values())


def layer_decay_multipliers(
    model: nn.Module,
    num_vit_layers: int,
    num_llm_layers: int,
    vit_decay_rate: Optional[float] = None,
    llm_decay_rate: Optional[float] = None,
    llm_lr_scale: Optional[float] = None,
) -> Dict[str, float]:
    """{parameter name: learning-rate multiplier} over `named_parameters`."""
    given = dict(vit_decay_rate=vit_decay_rate, llm_decay_rate=llm_decay_rate,
                 llm_lr_scale=llm_lr_scale)
    vit_rate, llm_rate, llm_scale = (
        given[k] if given[k] is not None else float(os.environ.get(env, 1.0))
        for k, env in _ENV.items()
    )

    def one(name: str) -> float:
        tower = name.split(".", 1)[0]
        if tower == "vision_model":
            n_layers, rate, scale = num_vit_layers, vit_rate, 1.0
        elif tower == "language_model":
            n_layers, rate, scale = num_llm_layers, llm_rate, llm_scale
        else:
            return 1.0
        m = re.search(r"\.layers\.(\d+)\.", name)
        if m:
            layer_id = int(m.group(1)) + 1
        elif "embeddings" in name or "patch_embedding" in name:
            layer_id = 0
        else:
            layer_id = n_layers + 1
        return scale * rate ** (n_layers + 1 - layer_id)

    return {name: one(name) for name, _ in model.named_parameters()}
