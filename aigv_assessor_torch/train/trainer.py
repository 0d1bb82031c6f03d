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

Every record of `<output_dir>/train_log.jsonl` (the losses, the eval
metrics) also goes to `utils/metrics_writer.MetricsWriter` under
`<output_dir>/logs`, opened when training starts or at the first record; a
writer that fails is logged and dropped, and training goes on, as in JAX.

Under a process group (`core/dist.init_dist`; torchrun, or JAX's launch
variables) the trainer lays the model out over `mesh` (default: every rank
on `data`): the towers split over `tensor` where JAX splits them, then FSDP2
over (data, fsdp) (`parallel/sharding.shard_params`), even at one rank, and
builds AdamW over the wrapped parameters. Each rank runs its rows of the
global batch (the ranks of a tensor group the same rows), and a step gives
what the one-process step over the global batch gives, as JAX's one program
over global arrays does:

- FSDP2 averages the gradients over the (data, fsdp) ranks, so each rank's
  loss is scaled by `local_weight * world / global_weight` before its
  backward, where the weight is what the loss averages over: the label
  tokens of the shifted cross-entropy (stage 1), the rows of the L1 (stage
  2, where equal local batches make the scale 1). Both sums run over the
  whole world, which counts each row once per tensor rank: the ratio is
  the one over (data, fsdp). The logged loss is the global one, the same on
  every rank, written once.
- The clip takes the norm of the whole gradients: the squared norms of the
  local shards summed over the `fsdp` ranks, those of the parameters split
  over `tensor` also over the tensor ranks, the others counted once.
- Dropout and drop path draw from a generator seeded from (seed, data
  rank): `seed + (rank << 32)`, the seed itself on data rank 0, so the
  ranks of a tensor group draw the same masks (a split input's dropout
  keeps its columns of the whole activation's mask, `models/lora.dropout`).
- Eval runs on every rank (FSDP2's all-gathers and the split layers'
  all-reduces keep the ranks in step); the primary's metrics decide the
  best checkpoint on all of them. Only the primary writes
  `train_log.jsonl`, the metrics and the checkpoints; every rank takes part
  in the gathers that checkpoints and artifacts need, which give the
  unsplit tensors (`parallel/tensor.unsplit`), so a checkpoint moves
  between any two layouts.

Without a process group nothing is wrapped and no collective runs: a
single-process run is the one-card trainer, bit for bit. The JAX trainer's
jitted step has no counterpart: the port runs eagerly.
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

from aigv_assessor_torch.core import dist as pdist
from aigv_assessor_torch.core.mesh import MeshConfig, data_coords, make_mesh
from aigv_assessor_torch.models import loading
from aigv_assessor_torch.models.lora import set_generator
from aigv_assessor_torch.parallel.sharding import (
    fsdp_group,
    full_tensor,
    local_tensor,
    shard_params,
)
from aigv_assessor_torch.parallel.tensor import model_split, split_leaves, unsplit
from aigv_assessor_torch.train.freeze import apply_freeze_, cast_frozen_, count_params
from aigv_assessor_torch.train.layer_decay import (
    layer_decay_multipliers,
    layer_decay_requested,
)
from aigv_assessor_torch.utils.metrics_writer import MetricsWriter

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


@torch.no_grad()
def clip_by_global_norm_(grads: List[torch.Tensor], max_norm: float,
                         group=None, split: Optional[List[bool]] = None,
                         tensor_group=None) -> torch.Tensor:
    """Scale `grads` in place by `max_norm / norm` if their global L2 norm is
    at least `max_norm`; returns the norm before clipping. Sharded grads
    (DTensors) count their local shards, whose squared norms are summed
    over `group` (the ranks that hold one tensor's shards). `split`: per
    gradient, True where its parameter is split over `tensor`; those squared
    norms are summed over `tensor_group` too, the others counted once."""
    grads = [local_tensor(g) for g in grads]
    norms = torch.stack([torch.linalg.vector_norm(g) for g in grads])
    if tensor_group is not None and split is not None and any(split):
        cut = torch.tensor(split, device=norms.device)
        sq = norms.square()
        whole, parts = sq[~cut].sum(), sq[cut].sum()
        if group is not None and torch.distributed.get_world_size(group) > 1:
            pdist.all_reduce_sum_(whole, group)
            pdist.all_reduce_sum_(parts, group)
        norm = (whole + pdist.all_reduce_sum_(parts, tensor_group)).sqrt()
    elif group is not None and torch.distributed.get_world_size(group) > 1:
        norm = pdist.all_reduce_sum_(norms.square().sum(), group).sqrt()
    else:
        norm = torch.linalg.vector_norm(norms)
    if norm >= max_norm:
        for g in grads:
            g.div_(norm).mul_(max_norm)
    return norm


def loss_weight(mb: Dict[str, torch.Tensor], stage: int) -> torch.Tensor:
    """What the micro-batch's loss is a mean over: its rows for the stage-2
    L1 (with `mos`), else its label tokens after the shift."""
    if stage >= 2 and mb.get("mos") is not None:
        return torch.tensor(mb["mos"].shape[0], dtype=torch.float64, device=mb["mos"].device)
    return (mb["labels"][:, 1:] != -100).sum().to(torch.float64)


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
        mesh=None,
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

        self.mesh = None
        if torch.distributed.is_initialized():
            self.mesh = mesh if mesh is not None else make_mesh(MeshConfig.auto())
            shard_params(model, self.mesh)
        # the parameters split over `tensor` (none without the axis)
        self.split = model_split(model)
        self.split_leaves = split_leaves(model) if self.split is not None else {}
        params = dict(model.named_parameters())
        self.device = next(iter(params.values())).device
        self.data_rank = data_coords(self.mesh)[0]
        self.generator = torch.Generator(device=self.device).manual_seed(
            cfg.seed + (self.data_rank << 32))
        set_generator(model, self.generator)

        rates = (cfg.vit_layer_decay_rate, cfg.llm_layer_decay_rate, cfg.llm_lr_scale)
        scales = {n: 1.0 for n in self.trainable}
        # JAX's optimizer chain then gains a link whose empty state its checkpoints record
        self.layer_decay = layer_decay_requested(*rates)
        if self.layer_decay:
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
        # opened by `train` or the first record: building a trainer writes nothing
        self.metrics_writer: Optional[MetricsWriter] = None
        self._metrics_failed = False

    # ------------------------------------------------------------- step ----

    def trainable_parameters(self) -> Dict[str, torch.Tensor]:
        params = dict(self.model.named_parameters())
        return {n: params[n] for n in self.trainable}

    def accumulate_gradients(self, micro_batches: Iterable[Dict[str, torch.Tensor]]) -> torch.Tensor:
        """Forward and backward of every micro-batch in `train()` mode; leaves
        the mean gradient in `.grad` and returns the mean loss."""
        self.model.train()
        self.optimizer.zero_grad(set_to_none=True)
        micro_batches = list(micro_batches)
        if not micro_batches:
            raise ValueError("a step needs at least one micro-batch")
        scales = self._loss_scales(micro_batches)
        loss_sum = None
        for mb, (grad_scale, log_scale) in zip(micro_batches, scales):
            out = self.model(mb["input_ids"], mb["pixel_values"], mb.get("attention_mask"),
                             labels=mb.get("labels"), mos=mb.get("mos"),
                             position_ids=mb.get("position_ids"))
            loss = out["loss"]
            (loss if grad_scale == 1.0 else loss * grad_scale).backward()
            loss = loss.detach() if log_scale == 1.0 else loss.detach() * log_scale
            loss_sum = loss if loss_sum is None else loss_sum + loss
        count = len(micro_batches)
        for p in self.trainable_parameters().values():
            if p.grad is None:  # a parameter the loss does not reach
                p.grad = torch.zeros_like(p)
            p.grad.div_(count)
        if self.mesh is not None:
            pdist.all_reduce_sum_(loss_sum)
        return loss_sum / count

    def _loss_scales(self, micro_batches) -> List[Any]:
        """(gradient scale, logged-loss scale) of each micro-batch: (1, 1)
        without a process group; else local_weight * world / global_weight
        and local_weight / global_weight (`loss_weight`), so that FSDP2's
        mean over ranks gives the global batch's gradient and the summed
        logs its loss."""
        if self.mesh is None:
            return [(1.0, 1.0)] * len(micro_batches)
        stage = self.model.config.stage
        local = torch.stack([loss_weight(mb, stage) for mb in micro_batches])
        total = pdist.all_reduce_sum_(local.clone())
        world = pdist.process_count()
        out = []
        for w, g in zip(local.tolist(), total.tolist()):
            share = w / max(g, 1.0)
            out.append((w * world / max(g, 1.0), share))
        return out

    def train_step(self, micro_batches: Iterable[Dict[str, torch.Tensor]]) -> torch.Tensor:
        """One optimizer step over the micro-batches -> their mean loss (a
        scalar tensor on the device; reading it synchronizes)."""
        loss = self.accumulate_gradients(micro_batches)
        params = self.trainable_parameters()
        clip_by_global_norm_([p.grad for p in params.values()], self.cfg.max_grad_norm,
                             fsdp_group(self.mesh) if self.mesh is not None else None,
                             split=[n in self.split_leaves for n in params],
                             tensor_group=self.split.group if self.split else None)
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
        self._open_metrics()  # before the clock: TensorBoard's import is slow
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
        # every rank evaluates; the primary's numbers decide for all of them
        metrics = pdist.broadcast_object(self.eval_fn(self.model, step))
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
        if not pdist.is_primary():
            return
        with open(os.path.join(self.cfg.output_dir, "train_log.jsonl"), "a") as f:
            f.write(json.dumps(record) + "\n")
        writer = self._open_metrics()
        if writer is None:
            return
        scalars = {k: v for k, v in record.items()
                   if isinstance(v, (int, float)) and k != "step"}
        try:
            writer.write(int(record.get("step", 0)), scalars)
        except Exception:  # metrics writing must never kill training
            logger.exception("metrics writer failed; training goes on without it")
            self._metrics_failed = True

    def _open_metrics(self) -> Optional[MetricsWriter]:
        """The metrics writer, opened at its first use (on the primary);
        None once it failed."""
        if self.metrics_writer is None and not self._metrics_failed and pdist.is_primary():
            try:
                self.metrics_writer = MetricsWriter(os.path.join(self.cfg.output_dir, "logs"))
            except Exception:  # metrics writing must never kill training
                logger.exception("metrics writer failed; training goes on without it")
                self._metrics_failed = True
        return None if self._metrics_failed else self.metrics_writer

    # ------------------------------------------------------------- state ---

    def state_dict(self) -> Dict[str, Any]:
        """The whole state of a run: every parameter and buffer (the frozen
        ones too), the optimizer's state in `torch.optim`'s form, the step,
        the generator and `best_metric`. A one-card trainer hands out its
        own tensors, detached, where they live (nothing is copied: write
        them out before the next step). A sharded trainer gathers the whole
        tensors to the CPU (a collective on every rank); they land on the
        primary, in the one-card form, the tensors split over `tensor` and
        their moments gathered into the unsplit layout; the other ranks get
        {}. The parameters are gathered one at a time, so a card holds one
        whole parameter at once, never the whole model.
        (`train/checkpoint.CheckpointManager` writes it as JAX's
        `TrainState`.)"""
        if self.mesh is None:
            return {
                "params": {n: t.detach() for n, t in self.model.state_dict().items()},
                "optimizer": self.optimizer.state_dict(),
                "step": self.step,
                "generator": self.generator.get_state(),
                "best_metric": self.best_metric,
            }
        from torch.distributed.checkpoint.state_dict import (
            StateDictOptions,
            get_optimizer_state_dict,
        )

        primary = pdist.is_primary()
        model_sd = {}
        for n, t in self.model.state_dict().items():
            t = self._whole(n, full_tensor(t.detach()))
            if primary:
                model_sd[n] = t
        # gathering the moments over `tensor` needs them (data, fsdp)-whole on every rank
        opts = StateDictOptions(full_state_dict=True, cpu_offload=self.split is None)
        optim_sd = get_optimizer_state_dict(self.model, self.optimizer, options=opts)
        if self.split is not None:
            optim_sd["state"] = {n: {k: self._whole(n, v) for k, v in st.items()}
                                 for n, st in optim_sd["state"].items()}
        if not primary:
            return {}
        return {
            "params": model_sd,
            "optimizer": _optimizer_by_index(optim_sd),
            "step": self.step,
            "generator": self.generator.get_state(),
            "best_metric": self.best_metric,
        }

    @torch.no_grad()
    def load_state_dict(self, state: Dict[str, Any]) -> None:
        """A state from `state_dict`, written at any world size, into this
        trainer (sharded or not): every parameter and buffer, the optimizer,
        the step. The generator keeps its rank's draws where the state
        comes from another rank count; a state whose `generator` is None
        restarts it from `seed + (data rank << 32) + step`."""
        names = set(self.model.state_dict())
        if set(state["params"]) != names:
            raise KeyError("the state holds other parameters than the model: "
                           f"{sorted(set(state['params']) ^ names)}")
        params = self.trainable_parameters()
        if self.mesh is None:
            self.model.load_state_dict(state["params"], strict=True)
            self.optimizer.load_state_dict(state["optimizer"])
        else:
            from torch.distributed.checkpoint.state_dict import (
                StateDictOptions,
                set_model_state_dict,
                set_optimizer_state_dict,
            )

            opts = StateDictOptions(full_state_dict=True, strict=True)
            optim = _optimizer_by_name(state["optimizer"], self.optimizer, params)
            model_sd = {n: self._shard(n, t) for n, t in state["params"].items()}
            optim["state"] = {n: {k: self._shard(n, v) for k, v in st.items()}
                              for n, st in optim["state"].items()}
            set_model_state_dict(self.model, model_sd, options=opts)
            set_optimizer_state_dict(self.model, self.optimizer, optim,
                                     options=StateDictOptions(full_state_dict=True))
        self.step = int(state["step"])
        if state["generator"] is None:
            self.generator.manual_seed(self.cfg.seed + (self.data_rank << 32) + self.step)
        elif self.data_rank == 0:
            self.generator.set_state(state["generator"].cpu())
        self.best_metric = float(state["best_metric"])

    def _whole(self, name: str, t: Any) -> Any:
        """`t` (a parameter or one of its moments) in the unsplit layout, on
        the CPU: gathered over `tensor` where `name` is split (a collective
        on every rank of the group)."""
        if name in self.split_leaves and isinstance(t, torch.Tensor) and t.ndim:
            t = unsplit(t, self.split_leaves[name], self.split)
        return t.cpu() if isinstance(t, torch.Tensor) else t

    def _shard(self, name: str, t: Any) -> Any:
        """This rank's shard of an unsplit `t` where `name` is split over
        `tensor`."""
        if name in self.split_leaves and isinstance(t, torch.Tensor) and t.ndim:
            return self.split_leaves[name].shard(t, self.split.rank, self.split.size)
        return t


def _optimizer_by_index(optim_sd: Dict[str, Any]) -> Dict[str, Any]:
    """A full optimizer state dict keyed by parameter names (what
    `get_optimizer_state_dict` gives) in `torch.optim`'s own form, keyed by
    each parameter's position over the groups: what a one-card trainer
    saves."""
    index: Dict[str, int] = {}
    groups = []
    for group in optim_sd["param_groups"]:
        ids = []
        for name in group["params"]:
            index[name] = len(index)
            ids.append(index[name])
        groups.append({**group, "params": ids})
    return {"state": {index[n]: v for n, v in optim_sd["state"].items()},
            "param_groups": groups}


def _optimizer_by_name(state: Dict[str, Any], optimizer, params: Dict[str, torch.Tensor]
                       ) -> Dict[str, Any]:
    """The inverse of `_optimizer_by_index` for this trainer's optimizer."""
    names = {id(p): n for n, p in params.items()}
    order = [names[id(p)] for g in optimizer.param_groups for p in g["params"]]
    groups, i = [], 0
    for group in state["param_groups"]:
        groups.append({**group, "params": order[i: i + len(group["params"])]})
        i += len(group["params"])
    return {"state": {order[k]: v for k, v in state["state"].items()},
            "param_groups": groups}


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
