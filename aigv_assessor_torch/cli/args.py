"""The CLIs' argument surface (`aigv_assessor_tpu/cli/args.py`), copied
without jax: every flag of the JAX parser with its default, so that a JAX
command line means the same here, plus `--device` (default `cuda`, as
`cli/score.py` has it; the tests pass `cpu`).

`--mesh_data` / `--mesh_fsdp` / `--mesh_tensor` lay the ranks of a
`torch.distributed` run (one process per card) out as JAX's mesh
(`cli/common.mesh_from_args`, `core/mesh.py`); `parse_args` refuses a size
out of range (below 0 for `--mesh_data`, whose 0 means world // (fsdp x
tensor), below 1 for the others).
"""

from __future__ import annotations

import argparse
from typing import List, Optional


def _bool(v: str) -> bool:
    return str(v).lower() in ("1", "true", "t", "yes", "y")


def build_parser(description: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=description)
    # ---- model ----
    p.add_argument("--model_name_or_path", type=str, default="")
    p.add_argument("--vision_path", type=str, default=None)
    p.add_argument("--llm_path", type=str, default=None)
    p.add_argument("--mlp_path", type=str, default=None)
    p.add_argument("--conv_style", type=str, default="internlm2-chat")
    p.add_argument("--force_image_size", type=int, default=448)
    p.add_argument("--down_sample_ratio", type=float, default=0.5)
    p.add_argument("--ps_version", type=str, default="v2")
    p.add_argument("--vision_select_layer", type=int, default=-1)
    p.add_argument("--drop_path_rate", type=float, default=0.1)
    p.add_argument("--use_backbone_lora", type=int, default=0)
    p.add_argument("--use_llm_lora", type=int, default=0)
    p.add_argument("--freeze_llm", type=_bool, default=True)
    p.add_argument("--freeze_backbone", type=_bool, default=True)
    p.add_argument("--freeze_mlp", type=_bool, default=False)
    p.add_argument("--unfreeze_lm_head", type=_bool, default=False)
    p.add_argument("--grad_checkpoint", type=_bool, default=True)
    p.add_argument("--vit_remat_policy", type=str, default="",
                   help="with --grad_checkpoint, what each ViT layer saves for its "
                        "backward, by a jax.checkpoint_policies name (e.g. "
                        "dots_with_no_batch_dims_saveable: the projections' and the "
                        "adapters' products; ops/remat.py); empty recomputes whole layers")
    # ---- data ----
    p.add_argument("--meta_path", type=str, required=True)
    p.add_argument(
        "--fused_meta_paths", type=str, nargs="*", default=None,
        help="stage-2 eval only: additional per-perspective meta JSONs over "
             "the SAME videos as --meta_path; all perspectives are scored "
             "in ONE pass per video (shared frame encode)",
    )
    p.add_argument("--max_seq_length", type=int, default=4096)
    p.add_argument("--max_dynamic_patch", type=int, default=6)
    p.add_argument("--min_dynamic_patch", type=int, default=1)
    p.add_argument("--dynamic_image_size", type=_bool, default=True)
    p.add_argument("--use_thumbnail", type=_bool, default=True)
    p.add_argument("--pad2square", type=_bool, default=False)
    p.add_argument("--group_by_length", type=_bool, default=True)
    p.add_argument("--dataloader_num_workers", type=int, default=4)
    p.add_argument("--num_segments", type=int, default=8)
    p.add_argument("--normalize_type", type=str, default="imagenet")
    # ---- training ----
    p.add_argument("--output_dir", type=str, default="work_dirs/run")
    p.add_argument("--overwrite_output_dir", type=_bool, default=False)
    p.add_argument("--do_train", type=_bool, default=False)
    p.add_argument("--bf16", type=_bool, default=True)
    p.add_argument("--num_train_epochs", type=float, default=1.0)
    p.add_argument("--per_device_train_batch_size", type=int, default=4)
    p.add_argument("--gradient_accumulation_steps", type=int, default=1)
    p.add_argument("--learning_rate", type=float, default=4e-5)
    p.add_argument("--weight_decay", type=float, default=0.01)
    p.add_argument("--warmup_ratio", type=float, default=0.03)
    p.add_argument("--lr_scheduler_type", type=str, default="cosine")
    p.add_argument("--logging_steps", type=int, default=1)
    p.add_argument("--evaluation_strategy", type=str, default="no")
    p.add_argument("--eval_steps", type=int, default=0)
    p.add_argument("--save_strategy", type=str, default="steps")
    p.add_argument("--save_steps", type=int, default=60)
    p.add_argument("--save_total_limit", type=int, default=1)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--resume_from_checkpoint", type=str, default=None)
    # ---- eval artifacts ----
    p.add_argument("--output_file", type=str, default="results.csv")
    p.add_argument("--metrics_file", type=str, default="metrics.txt")
    # ---- accepted for compatibility with the reference's shell scripts ----
    p.add_argument("--deepspeed", type=str, default=None, help="ignored")
    p.add_argument("--report_to", type=str, default="none")
    # ---- the JAX package's additions ----
    p.add_argument("--mesh_data", type=int, default=0,
                   help="data-parallel ranks; 0 = world // (fsdp * tensor)")
    p.add_argument("--mesh_fsdp", type=int, default=1,
                   help="ranks that shard parameters and optimizer state (FSDP2)")
    p.add_argument("--mesh_tensor", type=int, default=1,
                   help="tensor-parallel ranks: the float towers split by heads "
                        "(parallel/tensor.py)")
    p.add_argument("--model_scale", type=str, default="auto",
                   choices=["auto", "tiny", "2b", "8b"],
                   help="init scale when no checkpoint is given")
    p.add_argument("--eval_batch_size", type=int, default=8,
                   help="batched eval (the reference loops bs=1)")
    p.add_argument("--eval_w8a8", type=_bool, default=False,
                   help="fused eval at the W8A8 serving precision (int8 x int8 products "
                        "in both towers, ops/w8a8.py)")
    # ---- the port's ----
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to run on (cpu for tests)")
    return p


def parse_args(description: str, argv: Optional[List[str]] = None):
    args = build_parser(description).parse_args(argv)
    for flag in ("mesh_data", "mesh_fsdp", "mesh_tensor"):
        if getattr(args, flag) < (0 if flag == "mesh_data" else 1):
            raise ValueError(f"--{flag} {getattr(args, flag)}: out of range")
    return args
