"""Training loop (`aigv_assessor_tpu/train/trainer.py`): the optimizer step,
freeze, gradient accumulation, logging, periodic evaluation and checkpoints.

One optimizer step, as the JAX `Trainer._train_step` takes it:

- the model's forward with the micro-batch's `labels` (stage 1) or `mos`
  (stage 2) in `train()` mode gives the loss, and autograd runs over the
  trainable parameters only (`train/freeze.py`);
- the gradients of the micro-batches are summed and divided by their count,
  in fp32 (the trainable parameters are fp32 masters);
- clipping by the global norm as optax does it: scaled by
  `max_norm / norm` only when `norm >= max_norm`, with no epsilon
  (`torch.nn.utils.clip_grad_norm_` divides by `norm + 1e-6`);
- AdamW with the schedule's learning rate for the step count before the
  update (so a warm-up starts from 0 at the first step, as optax counts),
  weight decay on everything but biases, `scale`s and norm weights, and
  optionally the layer-decay multipliers as per-group learning-rate scales.
  `torch.optim.AdamW` decays by `p *= 1 - lr * wd` before the Adam update,
  which is optax's `-lr * (adam + wd * p)`.

Dropout and drop path draw from one `torch.Generator` on the model's device,
seeded from `TrainConfig.seed`, which the trainer hands to the model.

The mesh, the sharding and the jitted step of the JAX trainer have no
counterpart: the port runs eagerly on one card.
"""

from __future__ import annotations

import json
import logging
import math
import os
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterable, List, Optional

import torch
from torch import nn

from aigv_assessor_torch.models import loading
from aigv_assessor_torch.models.lora import set_generator
from aigv_assessor_torch.train.freeze import apply_freeze_, cast_frozen_, count_params
from aigv_assessor_torch.train.layer_decay import (
    layer_decay_multipliers,
    layer_decay_requested,
)

logger = logging.getLogger(__name__)


@dataclass
class TrainConfig:
    """Hyperparameters; the JAX `TrainConfig`, field for field."""

    output_dir: str = "work_dirs/run"
    learning_rate: float = 4e-5
    weight_decay: float = 0.01
    warmup_ratio: float = 0.03
    lr_scheduler_type: str = "cosine"  # 'cosine' | 'linear' | 'constant'
    num_train_epochs: float = 50.0
    per_device_train_batch_size: int = 4
    gradient_accumulation_steps: int = 1
    max_grad_norm: float = 1.0
    adam_beta1: float = 0.9
    adam_beta2: float = 0.999
    adam_epsilon: float = 1e-8
    logging_steps: int = 1
    save_steps: int = 60
    save_total_limit: int = 1
    eval_steps: int = 0  # 0 = no periodic eval
    seed: int = 42
    grad_checkpoint: bool = True
    freeze_backbone: bool = True
    freeze_llm: bool = True
    freeze_mlp: bool = False
    # output/tok embeddings trainable even with a frozen LLM
    unfreeze_lm_head: bool = False
    max_seq_length: int = 4096
    bf16: bool = True
    resume_from_checkpoint: Optional[str] = None
    # layer-wise LR decay; the environment variables of `train/layer_decay.py`
    # apply where these are None
    vit_layer_decay_rate: Optional[float] = None
    llm_layer_decay_rate: Optional[float] = None
    llm_lr_scale: Optional[float] = None
    output_file: str = "results.csv"
    metrics_file: str = "metrics.txt"
    # hold the frozen parameters in bf16 when the model computes in bf16: the
    # forward reads them in bf16 anyway
    frozen_bf16: bool = True


def make_schedule(cfg: TrainConfig, total_steps: int) -> Callable[[int], float]:
    """step -> learning rate, the optax schedules the JAX trainer builds:
    cosine or linear decay to 0 after a linear warm-up from 0 over
    `int(total_steps * warmup_ratio)` steps, or a constant."""
    lr = cfg.learning_rate
    warmup = int(total_steps * cfg.warmup_ratio)

    if cfg.lr_scheduler_type == "cosine":
        decay_steps = max(total_steps, warmup + 1) - warmup

        def cosine(step: int) -> float:
            if step < warmup:
                return lr * step / warmup
            t = min(step - warmup, decay_steps)
            return lr * 0.5 * (1.0 + math.cos(math.pi * t / decay_steps))

        return cosine
    if cfg.lr_scheduler_type == "linear":
        up, down = max(warmup, 1), max(total_steps - warmup, 1)

        def linear(step: int) -> float:
            if step < warmup:
                return lr * min(step, up) / up
            return lr * (1.0 - min(step - warmup, down) / down)

        return linear
    return lambda step: lr


def decays(jax_path: str) -> bool:
    """True where weight decay applies: not to a `bias` or `scale` leaf, nor
    to a `weight` under a module whose name contains 'norm'. The JAX
    `decay_mask` predicate, on a parameter's JAX path
    (`models/loading.jax_paths`): the flax LayerNorm's `scale` is a `weight`
    in the port."""
    *parents, leaf = jax_path.split("/")
    if leaf in ("bias", "scale"):
        return False
    if leaf == "weight" and any("norm" in p.lower() for p in parents):
        return False
    return True


def clip_by_global_norm_(grads: List[torch.Tensor], max_norm: float) -> torch.Tensor:
    """Scale `grads` in place by `max_norm / norm` if their global L2 norm is
    at least `max_norm`; returns the norm before clipping."""
    norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in grads]))
    if norm >= max_norm:
        for g in grads:
            g.div_(norm).mul_(max_norm)
    return norm


class Trainer:
    """Owns the model's freeze state, the optimizer and the step count.

    eval_fn(model, step) -> {metric: value}; on_best(model, step) is called
    on every new best `best_metric_key`; checkpoint_manager.save(step,
    trainer, best=...) (`train/checkpoint.CheckpointManager`)."""

    def __init__(
        self,
        model: nn.Module,
        train_config: TrainConfig,
        total_steps: int,
        eval_fn: Optional[Callable[[nn.Module, int], Dict[str, float]]] = None,
        best_metric_key: str = "accuracy",
        checkpoint_manager=None,
        on_best: Optional[Callable[[nn.Module, int], None]] = None,
    ):
        self.model = model
        self.cfg = cfg = train_config
        self.eval_fn = eval_fn
        self.best_metric_key = best_metric_key
        self.best_metric = float("-inf")
        self.ckpt = checkpoint_manager
        self.on_best = on_best
        self.step = 0

        self.trainable = apply_freeze_(
            model, model.config.stage, freeze_backbone=cfg.freeze_backbone,
            freeze_llm=cfg.freeze_llm, freeze_mlp=cfg.freeze_mlp,
            unfreeze_lm_head=cfg.unfreeze_lm_head,
        )
        if cfg.frozen_bf16 and model.precision.compute_dtype == torch.bfloat16:
            cast_frozen_(model, torch.bfloat16)
        counts = count_params(model)
        logger.info("parameters: %.1fM total, %.1fM trainable",
                    counts["total"] / 1e6, counts["trainable"] / 1e6)

        params = dict(model.named_parameters())
        self.device = next(iter(params.values())).device
        self.generator = torch.Generator(device=self.device).manual_seed(cfg.seed)
        set_generator(model, self.generator)

        rates = (cfg.vit_layer_decay_rate, cfg.llm_layer_decay_rate, cfg.llm_lr_scale)
        scales = {n: 1.0 for n in self.trainable}
        if layer_decay_requested(*rates):
            scales = layer_decay_multipliers(
                model, model.config.vision.num_hidden_layers,
                model.config.llm.num_hidden_layers, *rates,
            )
        # one group per (decays, learning-rate scale)
        paths = loading.jax_paths(model)
        groups: Dict[Any, Dict[str, Any]] = {}
        for n in self.trainable:
            key = (decays(paths[n][0]), scales[n])
            group = groups.setdefault(key, dict(
                params=[], weight_decay=cfg.weight_decay if key[0] else 0.0, lr_scale=key[1]))
            group["params"].append(params[n])
        self.schedule = make_schedule(cfg, total_steps)
        self.optimizer = torch.optim.AdamW(
            list(groups.values()), lr=cfg.learning_rate,
            betas=(cfg.adam_beta1, cfg.adam_beta2), eps=cfg.adam_epsilon,
        )
        self._metrics_log: List[Dict[str, Any]] = []

    # ------------------------------------------------------------- step ----

    def trainable_parameters(self) -> Dict[str, torch.Tensor]:
        params = dict(self.model.named_parameters())
        return {n: params[n] for n in self.trainable}

    def accumulate_gradients(self, micro_batches: Iterable[Dict[str, torch.Tensor]]) -> torch.Tensor:
        """Forward and backward of every micro-batch in `train()` mode; leaves
        the mean gradient in `.grad` and returns the mean loss."""
        self.model.train()
        self.optimizer.zero_grad(set_to_none=True)
        loss_sum, count = None, 0
        for mb in micro_batches:
            out = self.model(mb["input_ids"], mb["pixel_values"], mb.get("attention_mask"),
                             labels=mb.get("labels"), mos=mb.get("mos"),
                             position_ids=mb.get("position_ids"))
            out["loss"].backward()
            loss = out["loss"].detach()
            loss_sum = loss if loss_sum is None else loss_sum + loss
            count += 1
        if count == 0:
            raise ValueError("a step needs at least one micro-batch")
        for p in self.trainable_parameters().values():
            if p.grad is None:  # a parameter the loss does not reach
                p.grad = torch.zeros_like(p)
            p.grad.div_(count)
        return loss_sum / count

    def train_step(self, micro_batches: Iterable[Dict[str, torch.Tensor]]) -> torch.Tensor:
        """One optimizer step over the micro-batches -> their mean loss (a
        scalar tensor on the device; reading it synchronizes)."""
        loss = self.accumulate_gradients(micro_batches)
        clip_by_global_norm_([p.grad for p in self.trainable_parameters().values()],
                             self.cfg.max_grad_norm)
        lr = self.schedule(self.step)
        for group in self.optimizer.param_groups:
            group["lr"] = lr * group["lr_scale"]
        self.optimizer.step()
        self.step += 1
        return loss

    # -------------------------------------------------------------- loop ---

    def train(self, data_iter_fn: Callable[[int], Iterable[Any]]):
        """data_iter_fn(epoch) -> iterable of steps, each a sequence of
        micro-batch dicts (`input_ids`, `pixel_values`, `attention_mask`,
        `labels` or `mos`, optionally `position_ids`, tensors on the model's
        device)."""
        cfg = self.cfg
        os.makedirs(cfg.output_dir, exist_ok=True)
        t_start = time.time()
        for epoch in range(int(math.ceil(cfg.num_train_epochs))):
            for micro_batches in data_iter_fn(epoch):
                loss = self.train_step(micro_batches)
                step = self.step
                if step % cfg.logging_steps == 0:
                    rec = {"step": step, "epoch": epoch, "loss": float(loss),
                           "time": time.time() - t_start}
                    self._metrics_log.append(rec)
                    logger.info("step %d loss %.4f", step, rec["loss"])
                    self._write_log(rec)
                if cfg.eval_steps and step % cfg.eval_steps == 0:
                    self.maybe_eval(step)
                if cfg.save_steps and step % cfg.save_steps == 0:
                    self.save(step)
        self.save(self.step)
        return self

    def maybe_eval(self, step: int) -> None:
        if self.eval_fn is None:
            return
        self.model.eval()
        metrics = self.eval_fn(self.model, step)
        self._write_log({"step": step, **{f"eval_{k}": v for k, v in metrics.items()}})
        m = metrics.get(self.best_metric_key)
        if m is not None and m > self.best_metric:
            self.best_metric = m
            logger.info("new best %s=%.4f; saving", self.best_metric_key, m)
            self.save(step, best=True)
            if self.on_best is not None:
                self.on_best(self.model, step)

    def save(self, step: int, best: bool = False) -> None:
        if self.ckpt is not None:
            self.ckpt.save(step, self, best=best)

    def _write_log(self, record: Dict[str, Any]) -> None:
        with open(os.path.join(self.cfg.output_dir, "train_log.jsonl"), "a") as f:
            f.write(json.dumps(record) + "\n")

    # ------------------------------------------------------------- state ---

    def state_dict(self) -> Dict[str, Any]:
        """What a resumed run needs beside the frozen weights: the trainable
        parameters, the optimizer's moments, the step and the generator."""
        return {
            "params": {n: p.detach().clone() for n, p in self.trainable_parameters().items()},
            "optimizer": self.optimizer.state_dict(),
            "step": self.step,
            "generator": self.generator.get_state(),
            "best_metric": self.best_metric,
        }

    @torch.no_grad()
    def load_state_dict(self, state: Dict[str, Any]) -> None:
        params = self.trainable_parameters()
        if set(state["params"]) != set(params):
            raise KeyError("trainer state holds other trainable parameters than the model: "
                           f"{sorted(set(state['params']) ^ set(params))}")
        for n, p in params.items():
            p.copy_(state["params"][n])
        self.optimizer.load_state_dict(state["optimizer"])
        self.step = int(state["step"])
        self.generator.set_state(state["generator"].cpu())
        self.best_metric = float(state["best_metric"])


def microbatch(batch: Dict[str, torch.Tensor], accum: int) -> List[Dict[str, torch.Tensor]]:
    """Split a batch [B, ...] into `accum` micro-batches of B // accum."""
    out = []
    for i in range(accum):
        mb = {}
        for k, v in batch.items():
            b = v.shape[0]
            if b % accum:
                raise ValueError(f"{k}: batch {b} does not split into {accum} micro-batches")
            mb[k] = v[i * (b // accum) : (i + 1) * (b // accum)]
        out.append(mb)
    return out
