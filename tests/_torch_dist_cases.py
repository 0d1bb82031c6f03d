"""The multi-rank cases of tests/test_torch_distributed.py, run by each rank
of a gloo pool (`tests/_torch_dist_worker.py`) and, at world 1 without a
process group, by the test itself as the one-process reference over the
whole global batch. Nothing here imports jax.

Every case builds the tiny model from a seed in fp32 on the CPU (adapters
with non-zero `lora_b`, the score head's ReLUs open, dropout and drop path
0) and makes its global batch from numpy; a rank takes its contiguous rows
by its data rank (data index x fsdp + fsdp index, as the loaders shard):
under a `tensor` axis of size T (innermost), rank // T, so the ranks of one
tensor group hold the same rows.
"""

import numpy as np
import torch

from aigv_assessor_torch.cli.stage2_train import build_training_model
from aigv_assessor_torch.core.config import AssessorConfig
from aigv_assessor_torch.core.dist import process_count, process_index
from aigv_assessor_torch.core.mesh import MeshConfig, make_mesh
from aigv_assessor_torch.core.precision import Precision
from aigv_assessor_torch.models.generation import GenerationConfig, generate
from aigv_assessor_torch.train.checkpoint import CheckpointManager
from aigv_assessor_torch.train.trainer import TrainConfig, Trainer, microbatch

CTX = 7  # <IMG_CONTEXT> id
T = 2  # frames per video
TEXT = 12
GLOBAL_B = 4
STEPS = 2


def config(stage: int) -> AssessorConfig:
    lora = dict(use_backbone_lora=2, use_llm_lora=4) if stage == 2 else {}
    return AssessorConfig.tiny(stage=stage, lora_dropout=0.0, **lora).replace(
        img_context_token_id=CTX)


@torch.no_grad()
def _open_(model):
    """Adapters that move from the first step, a score head that passes
    its readout through."""
    rng = np.random.default_rng(1)
    for name, p in model.named_parameters():
        if name.endswith("lora_b"):
            p.copy_(torch.from_numpy(rng.normal(0, 0.05, tuple(p.shape)).astype(np.float32)))
        elif name.startswith("mlpscore."):
            p.copy_(torch.from_numpy(rng.uniform(0.01, 0.1, tuple(p.shape)).astype(np.float32)))


def build(stage: int):
    model = build_training_model(config(stage), device="cpu", precision=Precision.fp32(),
                                 seed=0, grad_checkpoint=True,
                                 train_config=TrainConfig(frozen_bf16=False))
    _open_(model)
    return model


def global_batch(cfg: AssessorConfig, step: int, stage: int):
    """The global batch of one step: right-padded prompts with every context
    slot, frames, MOS / 100 and, at stage 1, labels on a tail of each row
    whose length differs from row to row (the ranks hold unequal counts of
    label tokens)."""
    b = GLOBAL_B
    rng = np.random.default_rng(100 + step)
    n_ctx = T * cfg.num_image_token + 1
    n = n_ctx + TEXT
    ids = rng.integers(10, 500, (b, n)).astype(np.int64)
    ids[:, 1: 1 + n_ctx] = CTX
    mask = np.ones((b, n), bool)
    mask[1:, n - 3:] = False
    ids[1:, n - 3:] = 2
    out = {
        "input_ids": torch.from_numpy(ids),
        "pixel_values": torch.from_numpy(rng.normal(size=(b, T, 56, 56, 3)).astype(np.float32)),
        "attention_mask": torch.from_numpy(mask),
    }
    if stage == 2:
        out["mos"] = torch.from_numpy(rng.uniform(0.2, 0.9, b).astype(np.float32))
    else:
        labels = np.full((b, n), -100, np.int64)
        for row, k in enumerate((2, 3, 9, 11)):  # ranks of world 2: 5 and 20 tokens
            labels[row, n - 3 - k: n - 3] = ids[row, n - 3 - k: n - 3]
        out["labels"] = torch.from_numpy(labels)
    return out


def tensor_size(layout) -> int:
    return layout[2] if layout is not None and len(layout) > 2 else 1


def rows(batch, dim: int = 0, tensor: int = 1):
    """This rank's contiguous rows of a global batch (its data rank's)."""
    w, r = process_count() // tensor, process_index() // tensor
    return {k: v.narrow(dim, v.shape[dim] // w * r, v.shape[dim] // w) for k, v in batch.items()}


def trainer_for(model, out_dir: str, stage: int, layout=None, accum: int = 1) -> Trainer:
    mesh = make_mesh(MeshConfig(*layout)) if layout is not None else None
    tc = TrainConfig(output_dir=out_dir, learning_rate=1e-3, warmup_ratio=0.0,
                     num_train_epochs=1, gradient_accumulation_steps=accum,
                     frozen_bf16=False, max_grad_norm=1.0)
    return Trainer(model, tc, total_steps=STEPS, mesh=mesh)


LAYOUT_WORLD = 2  # the world the reference's micro-batches are laid out for


def step_batches(cfg, step: int, stage: int, accum: int, layout=None,
                 layout_world: int = LAYOUT_WORLD):
    """The micro-batches of one step on this rank: global micro-batch i is
    the data ranks' i-th micro-batches in rank order (JAX's per-process
    layout). The one-process reference lays them out for `layout_world`
    data ranks."""
    batch = global_batch(cfg, step, stage)
    w = process_count()
    if w == 1:  # the one-process reference assembles the same global micro-batches
        per = GLOBAL_B // (accum * layout_world)
        order = [r * accum * per + i * per + j for i in range(accum)
                 for r in range(layout_world) for j in range(per)]
        batch = {k: v[order] for k, v in batch.items()}
        return microbatch(batch, accum)
    return microbatch(rows(batch, tensor=tensor_size(layout)), accum)


def train_case(stage: int, layout=None, accum: int = 1, out_dir: str = "/tmp",
               layout_world: int = LAYOUT_WORLD):
    """-> {'losses': [per step], 'weights': {name: tensor}} of STEPS steps
    (whole: gathered over every axis)."""
    model = build(stage)
    cfg = model.config
    trainer = trainer_for(model, out_dir, stage, layout, accum)
    losses = []
    for step in range(STEPS):
        losses.append(float(trainer.train_step(
            step_batches(cfg, step, stage, accum, layout, layout_world))))
    # the primary's; the other ranks' results are not read
    return {"losses": losses, "weights": trainer.state_dict().get("params", {})}


def save_after_one_step(ckpt_dir: str, layout=None, out_dir: str = "/tmp"):
    """A stage-2 run's checkpoint after its first step; -> the second step's
    loss when the same run goes on."""
    model = build(2)
    trainer = trainer_for(model, out_dir, 2, layout)
    trainer.train_step(step_batches(model.config, 0, 2, 1, layout))
    CheckpointManager(ckpt_dir).save(1, trainer)
    return float(trainer.train_step(step_batches(model.config, 1, 2, 1, layout)))


def resume_and_step(ckpt_dir: str, layout=None, out_dir: str = "/tmp"):
    """-> (step restored, the loss of the step after it)."""
    model = build(2)
    trainer = trainer_for(model, out_dir, 2, layout)
    CheckpointManager(ckpt_dir).restore(trainer)
    step = trainer.step
    return step, float(trainer.train_step(step_batches(model.config, step, 2, 1, layout)))


# -------------------------------------------------------------- inference --

P = 2
GEN_TOKENS = 8


def perspective_inputs(cfg):
    """[B, P, N] prompts sharing a prefix that holds every context slot, and
    frames."""
    rng = np.random.default_rng(7)
    n_ctx = T * cfg.num_image_token + 1
    prefix, suffix = 1 + n_ctx + 2, 6
    ids = rng.integers(10, 500, (GLOBAL_B, P, prefix + suffix)).astype(np.int64)
    ids[:, :, :prefix] = ids[:, :1, :prefix]
    ids[:, :, 1: 1 + n_ctx] = CTX
    mask = np.ones(ids.shape, bool)
    mask[1, :, -2:] = False
    px = rng.normal(size=(GLOBAL_B, T, 56, 56, 3)).astype(np.float32)
    return (torch.from_numpy(ids), torch.from_numpy(mask), torch.from_numpy(px), prefix)


def gen_inputs(cfg):
    """Left-padded prompts with every context slot, and frames."""
    rng = np.random.default_rng(8)
    n_ctx = T * cfg.num_image_token + 1
    n = 3 + n_ctx + 6
    ids = rng.integers(10, 500, (GLOBAL_B, n)).astype(np.int64)
    ids[:, 3: 3 + n_ctx] = CTX
    mask = np.ones((GLOBAL_B, n), np.int64)
    mask[2, :2] = 0
    ids[2, :2] = 0
    px = rng.normal(size=(GLOBAL_B, T, 56, 56, 3)).astype(np.float32)
    return torch.from_numpy(ids), torch.from_numpy(mask), torch.from_numpy(px)


@torch.no_grad()
def inference_case(shard: bool, eos: int = -1, layout=None):
    """-> {'scores': [B, P] without the shared prefix, 'scores_prefix': with
    it, 'tokens': [B, GEN_TOKENS] greedy} of this rank's rows (the whole
    batch at world 1); `layout` the (data, fsdp, tensor) mesh, by default
    every rank on fsdp."""
    from aigv_assessor_torch.models.loading import shard_for_inference

    model = build(2).eval()
    cfg = model.config
    tensor = tensor_size(layout)
    if shard:
        _, model = shard_for_inference(
            model, mesh_config=MeshConfig(*layout) if layout is not None else None)
    ids, mask, px, prefix = perspective_inputs(cfg)
    r = rows({"ids": ids, "mask": mask, "px": px}, tensor=tensor)
    out = {
        "scores": model.score_perspectives(r["ids"], r["px"], r["mask"]),
        "scores_prefix": model.score_perspectives(r["ids"], r["px"], r["mask"],
                                                  shared_prefix_len=prefix),
    }
    ids, mask, px = gen_inputs(cfg)
    r = rows({"ids": ids, "mask": mask, "px": px}, tensor=tensor)
    out["tokens"] = torch.as_tensor(generate(
        model, None, r["ids"], r["px"], r["mask"],
        gcfg=GenerationConfig(max_new_tokens=GEN_TOKENS, eos_token_id=eos), with_motion=True))
    return out


def gather_rows(t: torch.Tensor, tensor: int = 1):
    """Every data rank's rows, in rank order; under a `tensor` axis of size
    T > 1, (those rows, every rank's copy [world, ...] to hold the ranks of
    a tensor group against each other)."""
    import torch.distributed as dist

    if not dist.is_initialized():
        return t
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, t.contiguous())
    if tensor == 1:
        return torch.cat(parts)
    return torch.cat(parts[::tensor]), torch.stack(parts)

