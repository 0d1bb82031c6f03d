"""Where one training step spends its time on the card.

    python -m aigv_assessor_torch.tools.profile_train_step [--steps 3] [--stage 1|2]
        [--config CONFIG.json] [--batch 4]

Builds the InternVL2-2B training model from a seed, or the model of a
reference-format `config.json` (`--config`, e.g. InternVL2-26B's), and
steps it on one synthetic batch of `--batch` videos x 8 frames x 448 px with
a 2113-token prompt, the shapes `chip_smoke.py` trains at. Stage 2: LoRA rank
8 in both towers, bf16 with fp32 adapters, per-layer checkpointing, dropout
on, the L1 loss on MOS. Stage 1: `mlp1` and `motion_mlp` in fp32 on the text
loss of the last 10 tokens, both towers frozen in bf16. After one warm-up
step it prints, as JSON lines:

- per step, with CUDA events: the forward (first pass), the backward (which
  holds the recompute of every layer), and clipping plus AdamW;
- over one more step under `torch.profiler`: device time by kind of kernel
  (the hand-written attention kernels by name, dense GEMMs, cuDNN,
  everything else), and the profiled device time against the step's wall
  time (the rest is the device's idle share);
- the card's name and power limit beside every number.

Needs a CUDA card; there is no CPU mode.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

CTX, FRAMES, IMAGE, TEXT, BATCH = 7, 8, 448, 64, 4
KINDS = (  # (label, substrings of the kernel's name)
    ("attention_fwd", ("flash_fwd_kernel",)),
    ("attention_bwd_dq", ("flash_bwd_dq_kernel",)),
    ("attention_bwd_dkv", ("flash_bwd_dkv_kernel",)),
    ("gemm", ("gemm", "nvjet", "cutlass", "cublas")),
    ("cudnn", ("cudnn", "conv")),
)


def kind_of(name: str) -> str:
    low = name.lower()
    for label, needles in KINDS:
        if any(n in low for n in needles):
            return label
    return "elementwise_and_other"


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--steps", type=int, default=3)
    parser.add_argument("--stage", type=int, choices=(1, 2), default=2)
    parser.add_argument("--config", help="a reference-format config.json (default: 2B)")
    parser.add_argument("--batch", type=int, default=BATCH, help="videos per step")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("profile_train_step: needs a CUDA card", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]

    from aigv_assessor_torch.cli.stage2_train import build_training_model, prepare_batch
    from aigv_assessor_torch.core.config import LLM_2B, AssessorConfig
    from aigv_assessor_torch.train.trainer import (
        TrainConfig, Trainer, clip_by_global_norm_)

    cfg = AssessorConfig.from_json(args.config) if args.config else AssessorConfig(llm=LLM_2B)
    lora = dict(use_backbone_lora=8, use_llm_lora=8) if args.stage == 2 else {}
    cfg = cfg.replace(stage=args.stage, img_context_token_id=CTX, **lora)
    with tempfile.TemporaryDirectory() as out_dir:
        tc = TrainConfig(output_dir=out_dir, learning_rate=1e-4, warmup_ratio=0.0,
                         lr_scheduler_type="constant")
        model = build_training_model(cfg, device=device, seed=0, train_config=tc)
        trainer = Trainer(model, tc, 100)
    b = args.batch
    rng = np.random.default_rng(0)
    n_ctx = FRAMES * cfg.num_image_token + 1
    ids = rng.integers(10, cfg.llm.vocab_size, (b, n_ctx + TEXT))
    ids[:, 1 : 1 + n_ctx] = CTX
    labels = np.full(ids.shape, -100)
    labels[:, -10:] = ids[:, -10:]
    mb = prepare_batch(
        model, torch.as_tensor(ids),
        torch.as_tensor(rng.integers(0, 256, (b, FRAMES, IMAGE, IMAGE, 3), dtype=np.uint8)),
        torch.ones((b, n_ctx + TEXT), dtype=torch.bool),
        torch.as_tensor(rng.uniform(20.0, 90.0, b), dtype=torch.float32)
        if args.stage == 2 else None,
        labels=torch.as_tensor(labels) if args.stage == 1 else None,
    )
    def step(timed: bool) -> dict:
        marks = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        model.train()
        trainer.optimizer.zero_grad(set_to_none=True)
        marks[0].record()
        loss = model(mb["input_ids"], mb["pixel_values"], mb["attention_mask"],
                     labels=mb.get("labels"), mos=mb.get("mos"))["loss"]
        marks[1].record()
        loss.backward()
        marks[2].record()
        clip_by_global_norm_([p.grad for p in trainer.trainable_parameters().values()],
                             trainer.cfg.max_grad_norm)
        trainer.optimizer.step()
        marks[3].record()
        torch.cuda.synchronize()
        if not timed:
            return {}
        names = ("forward_ms", "backward_with_recompute_ms", "clip_and_adamw_ms")
        out = {n: marks[i].elapsed_time(marks[i + 1]) for i, n in enumerate(names)}
        out["step_ms"] = marks[0].elapsed_time(marks[3])
        return out

    step(timed=False)  # warm-up: cuDNN plans, the allocator, the kernels' first load
    for i in range(args.steps):
        print(json.dumps({"step": i, **step(timed=True), "card": card}), flush=True)

    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step(timed=False)
    wall_ms = (time.perf_counter() - t0) * 1e3
    by_kind: dict = {}
    for evt in prof.key_averages():
        device_us = getattr(evt, "self_device_time_total", 0) or 0
        if device_us and evt.device_type.name != "CPU":
            k = kind_of(evt.key)
            by_kind[k] = by_kind.get(k, 0.0) + device_us / 1e3
    total = sum(by_kind.values())
    print(json.dumps({
        "profiled_step": {k: round(v, 3) for k, v in sorted(by_kind.items(), key=lambda kv: -kv[1])},
        "device_ms": round(total, 3), "wall_ms_under_profiler": round(wall_ms, 3),
        "peak_gib": torch.cuda.max_memory_allocated(device) / 2**30, "card": card,
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
