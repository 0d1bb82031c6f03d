"""Checkpoints (`aigv_assessor_tpu/train/checkpoint.py`).

- `save_lora_weights` / `load_lora_weights`: the adapter leaves alone, as
  one safetensors file keyed by the JAX path names
  (`vision_model/layers/attn/qkv/lora_a`, ...), each holding the layers
  stacked on a leading axis as the JAX tree holds them. The JAX package
  writes the same flat dictionary as msgpack, which needs flax; the keys and
  arrays are the same.
- `save_trainable_weights`: any set of parameters (stage 1: `mlp1` and
  `motion_mlp`) the same way, in the JAX tree's layout (a dense kernel
  [in, out]).
- `CheckpointManager`: the trainer's state (trainable parameters, optimizer
  moments, step, generator state) under `step_<n>/`, the newest
  `save_total_limit` kept, and a single `best/` slot. The frozen weights are
  not part of it: a resumed run builds them as the first run did. Restoring
  the JAX package's orbax checkpoints is not ported yet (ROADMAP.md,
  Queue 1).
"""

from __future__ import annotations

import logging
import os
import re
import shutil
from typing import Dict, List, Optional

import torch
from torch import nn

from aigv_assessor_torch.models import loading
from aigv_assessor_torch.models.lora import is_lora_param

logger = logging.getLogger(__name__)


def _leaves(model: nn.Module, keep) -> Dict[str, List[torch.nn.Parameter]]:
    """{JAX path: the port's parameters named by `keep`, of layers 0..L-1 in
    order, or the one parameter outside the layers}."""
    params = dict(model.named_parameters())
    by_path: Dict[str, Dict[int, torch.nn.Parameter]] = {}
    for name, (path, layer) in loading.jax_paths(model).items():
        if name in params and keep(name):
            by_path.setdefault(path, {})[0 if layer is None else layer] = params[name]
    return {path: [layers[i] for i in range(len(layers))] for path, layers in by_path.items()}


def _lora_leaves(model: nn.Module) -> Dict[str, List[torch.nn.Parameter]]:
    return _leaves(model, is_lora_param)


def extract_lora(model: nn.Module) -> Dict[str, torch.Tensor]:
    """Flat {JAX path: [L, ...] tensor on the CPU} of the adapter leaves."""
    return {
        path: torch.stack([p.detach().cpu() for p in leaves])
        for path, leaves in _lora_leaves(model).items()
    }


def extract_params(model: nn.Module, names) -> Dict[str, torch.Tensor]:
    """Flat {JAX path: tensor on the CPU} of the named parameters in the JAX
    tree's layout: a dense `kernel` [in, out], layers stacked on a leading
    axis."""
    wanted = set(names)
    paths = dict(loading.jax_paths(model).values())
    out = {}
    for path, leaves in _leaves(model, lambda n: n in wanted).items():
        ts = [p.detach().cpu() for p in leaves]
        if path.endswith("kernel"):
            ts = [t.t() if t.ndim == 2 else t for t in ts]
        out[path] = torch.stack(ts).contiguous() if paths[path] is not None else ts[0].contiguous()
    return out


def save_trainable_weights(path: str, model: nn.Module, names) -> None:
    """The named parameters (`extract_params`) as one safetensors file."""
    from safetensors.torch import save_file

    tensors = extract_params(model, names)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    save_file(tensors, path)
    logger.info("saved %d trainable tensors to %s", len(tensors), path)


def save_lora_weights(path: str, model: nn.Module) -> None:
    from safetensors.torch import save_file

    lora = extract_lora(model)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    save_file(lora, path)
    logger.info("saved %d LoRA tensors to %s", len(lora), path)


@torch.no_grad()
def load_lora_weights(path: str, model: nn.Module) -> nn.Module:
    """Copy a LoRA-only artifact into the model's adapters, in place."""
    from safetensors.torch import load_file

    leaves = _lora_leaves(model)
    for key, value in load_file(path).items():
        if key not in leaves:
            raise KeyError(f"LoRA tensor {key} not present in the model")
        if value.shape[0] != len(leaves[key]):
            raise ValueError(f"{key}: {value.shape[0]} layers, the model has {len(leaves[key])}")
        for p, v in zip(leaves[key], value):
            p.copy_(v)
    return model


class CheckpointManager:
    def __init__(self, directory: str, save_total_limit: int = 1):
        self.directory = os.path.abspath(directory)
        self.keep = max(save_total_limit, 1)
        os.makedirs(self.directory, exist_ok=True)

    def _steps(self) -> List[int]:
        found = (re.fullmatch(r"step_(\d+)", d) for d in os.listdir(self.directory))
        return sorted(int(m.group(1)) for m in found if m)

    def _path(self, slot: str) -> str:
        return os.path.join(self.directory, slot, "state.pt")

    def save(self, step: int, trainer, best: bool = False) -> None:
        state = trainer.state_dict()
        for slot in [f"step_{step}"] + (["best"] if best else []):
            os.makedirs(os.path.dirname(self._path(slot)), exist_ok=True)
            torch.save(state, self._path(slot))
        for old in self._steps()[: -self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{old}"))
        logger.info("saved checkpoint step %d%s", step, " (best)" if best else "")

    def latest_step(self) -> Optional[int]:
        steps = self._steps()
        return steps[-1] if steps else None

    def restore(self, trainer, step: Optional[int] = None) -> None:
        """Load the state of `step` (default: the newest) into `trainer`."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        self._load(trainer, f"step_{step}")

    def restore_best(self, trainer) -> None:
        self._load(trainer, "best")

    def _load(self, trainer, slot: str) -> None:
        state = torch.load(self._path(slot), map_location=trainer.device, weights_only=True)
        trainer.load_state_dict(state)
