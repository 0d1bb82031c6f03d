"""Shared CLI assembly (`aigv_assessor_tpu/cli/common.py`): config ->
tokenizer -> model, for the CLIs.

- `config_from_args`: the checkpoint's `config.json` when there is one (its
  decoder any of JAX's four: InternLM2, Llama, Qwen2 or Phi-3), else the
  model scale (`tiny`, `2b`, or the 8B default), then the pipeline flags.
- `load_tokenizer`: the checkpoint's `tokenizer.json` / `tokenizer.model`,
  else the built-in test tokenizer.
- `quant_components`: JAX's `AIGV_FUSE_QUANT` / `AIGV_QUANT_ROWS` switches,
  parsed as JAX parses them ('0' none, '1' both towers, else a comma list of
  'vit' / 'llm'; unset means 'vit'). This is the only place in the port that
  reads them: the models read `Precision.fuse_quant` / `quant_rows`.
- `build_serving_model`: the model on a device in a float or quantized
  precision, from a state_dict or a seed, built tensor by tensor; the
  config's LoRA adapters live over the base, as JAX's eval runs them.
- `model_weights`: the weights of `--model_name_or_path`, or None (`--seed`);
  `graft_weights`: the `--vision_path` / `--llm_path` / `--mlp_path` parts
  (JAX's `_graft_subcheckpoints`), which the builders load over either.
- `config_and_tokenizer`: the config (with the tokenizer's `<IMG_CONTEXT>`
  id) and the tokenizer from the CLI flags; the training CLIs build their
  model from these (`cli/stage2_train.build_training_model`).
- `mesh_from_args`: the `--mesh_data` / `--mesh_fsdp` / `--mesh_tensor`
  layout of the process group's ranks (`core/mesh.py`), `data` defaulting
  to world // (fsdp * tensor) as in JAX; None in a single-process run.
- `build_model_and_tokenizer`: all of the above from the CLI flags,
  `(config, model, tokenizer)`: the eval CLIs' assembly (stage 1 or 2, on
  `--device`, bf16 or fp32 with `--bf16 False`, adapters live as JAX's eval
  runs them); `build_serving_stack`, the score and serve CLIs', fills the
  flags it does not take with the training CLIs' defaults and no adapters
  (`serving_args`).

Another `--force_image_size` is taken by the ViT's position-embedding
interpolation, as in JAX.
"""

from __future__ import annotations

import dataclasses
import logging
import os
from types import SimpleNamespace
from typing import Dict, FrozenSet, Mapping, Optional, Tuple

import torch

from aigv_assessor_torch.core.config import LLM_2B, AssessorConfig
from aigv_assessor_torch.core.dist import process_count
from aigv_assessor_torch.core.mesh import MeshConfig, check_mesh, make_mesh
from aigv_assessor_torch.core.precision import COMPONENTS, Precision
from aigv_assessor_torch.data.tokenizer import AIGVTokenizer, build_test_tokenizer
from aigv_assessor_torch.models.assessor import AIGVAssessor
from aigv_assessor_torch.models.loading import (
    init_lora_,
    init_random_,
    jax_params_file,
    load_jax_params,
    load_reference_checkpoint,
    load_weights_,
    serving_precision,
    weights_from_jax,
)

__all__ = ["LLM_2B", "build_model_and_tokenizer", "build_serving_model", "build_serving_stack",
           "config_and_tokenizer", "config_from_args", "graft_weights", "load_tokenizer",
           "mesh_from_args", "model_weights", "quant_components", "serving_args"]

logger = logging.getLogger(__name__)


def config_from_args(args, stage: int) -> AssessorConfig:
    ckpt_config = os.path.join(args.model_name_or_path or "", "config.json")
    if args.model_name_or_path and os.path.exists(ckpt_config):
        cfg = AssessorConfig.from_json(ckpt_config)
    elif args.model_scale == "tiny":
        cfg = AssessorConfig.tiny()
    elif args.model_scale == "2b":
        cfg = AssessorConfig(llm=LLM_2B)
    else:
        cfg = AssessorConfig()  # 8B default
    cfg = cfg.replace(
        stage=stage,
        downsample_ratio=args.down_sample_ratio,
        ps_version=args.ps_version,
        select_layer=args.vision_select_layer,
        template=args.conv_style,
        max_dynamic_patch=args.max_dynamic_patch,
        min_dynamic_patch=args.min_dynamic_patch,
        dynamic_image_size=args.dynamic_image_size,
        use_thumbnail=args.use_thumbnail,
        pad2square=args.pad2square,
        use_backbone_lora=args.use_backbone_lora,
        use_llm_lora=args.use_llm_lora,
    )
    cfg = cfg.replace(
        vision=dataclasses.replace(cfg.vision, drop_path_rate=args.drop_path_rate)
    )
    if args.model_scale != "tiny":
        cfg = cfg.replace(force_image_size=args.force_image_size)
    return cfg


def load_tokenizer(args, config: AssessorConfig) -> AIGVTokenizer:
    path = args.model_name_or_path or ""
    # the checkpoint's tokenizer.json, or its sentencepiece tokenizer.model
    # (what real InternLM2 / InternVL2 checkpoints ship); the built-in test
    # tokenizer only when it has neither
    if path and (
        os.path.exists(os.path.join(path, "tokenizer.json"))
        or os.path.exists(os.path.join(path, "tokenizer.model"))
    ):
        return AIGVTokenizer.from_pretrained(path, model_max_length=args.max_seq_length)
    logger.warning("no tokenizer.json/tokenizer.model found; using built-in test tokenizer")
    return build_test_tokenizer(model_max_length=args.max_seq_length)


def quant_components(name: str, environ: Optional[Mapping[str, str]] = None) -> FrozenSet[str]:
    """The towers JAX's switch `name` (AIGV_FUSE_QUANT or AIGV_QUANT_ROWS)
    turns on, with JAX's parse (`aigv_assessor_tpu/ops/quant_fuse.py:50-71`)."""
    v = (os.environ if environ is None else environ).get(name, "vit")
    if v == "0":
        return frozenset()
    if v == "1":
        return COMPONENTS
    return frozenset(c for c in v.split(",") if c in COMPONENTS)


@torch.no_grad()
def build_serving_model(
    config: AssessorConfig,
    *,
    device: torch.device | str,
    precision: Precision = Precision(),
    seed: int = 0,
    weights: Optional[Mapping[str, torch.Tensor]] = None,
    int8: bool = False,
    int4: bool = False,
    w8a8: bool = False,
    kv_int8: bool = False,
    grafts: Optional[Mapping[str, torch.Tensor]] = None,
) -> AIGVAssessor:
    """The model on `device` in `precision.compute_dtype`, in eval mode, as
    the JAX CLIs' `build_serving_stack` and `build_model_and_tokenizer` +
    `quantize_for_serving` make it.

    The modes: W8A8 (`w8a8=True` or `precision.w8a8`: both towers'
    projections) or weight-only (`int8=True` / `int4=True` or the
    precision's `int8_weights` / `int4_weights`: the decoder's projections
    and the LM head; int4 first when both are set), everything else in the
    compute dtype, the scales fp32. `w8a8` with `int8` or `int4` raises
    ValueError. `kv_int8` (or `precision.kv_int8`) changes no weight:
    generation then keeps its KV cache in int8, under any of the modes
    above. The precision's `fuse_quant` / `quant_rows` pick the W8A8 feeds.

    `weights`, a float state_dict of `AIGVAssessor(config)` (e.g.
    `load_reference_checkpoint`'s, or `weights_from_jax`'s, whose stored
    int8 / int4 kernels follow JAX's rules for a quantized tree: see
    `models/loading.load_weights_`), fills what it holds; what it lacks may
    only be the score head, then drawn by `init_score_head_(seed + 1)`, and
    the LoRA adapters, then drawn by `init_lora_(seed + 2)` with `lora_b`
    zero. Without `weights` all but the adapters come from
    `init_random_(seed)`: one seed gives the same base weights in every
    precision. Either way the model is built in its own precision, each base
    tensor drawn or loaded in fp32 and stored rounded or quantized, one at a
    time (`models/loading._base_leaves`), so no fp32 copy of the model is
    held: InternVL2-26B's 25.5 G values fit the card in bf16 and in the
    quantized modes.

    Adapters (the config's `use_backbone_lora` / `use_llm_lora`, which a
    stage-2 checkpoint carries) stay live over the base in every mode, as
    JAX's eval runs `LoRADense` over the quantized base: quantize(W) +
    delta, not quantize(W + delta). A model to serve without them, as the
    JAX serving stack builds with `use_*_lora=0`, takes weights whose
    adapters `models/lora.merge_lora_` folded into the float bases.

    `grafts` (`graft_weights`) then replace whole subtrees of what
    `weights` or the seed gave, as JAX grafts its parts over its loaded or
    initialised tree."""
    target = serving_precision(precision, w8a8=w8a8, int8=int8, int4=int4, kv_int8=kv_int8)
    with torch.device("meta"):
        model = AIGVAssessor(config, target)
    model = model.to(precision.compute_dtype).to_empty(device=device)
    if weights is None:
        init_lora_(init_random_(model, seed), seed + 2)
    else:
        load_weights_(model, weights, seed)
    if grafts:
        load_weights_(model, grafts, seed, partial=True)
    return model.eval()


def model_weights(args, config: AssessorConfig) -> Optional[Dict[str, torch.Tensor]]:
    """The weights of `AIGVAssessor(config)` from `--model_name_or_path`, in
    this order: a directory holding a JAX tree (`params.msgpack` or
    `params.safetensors`, `weights_from_jax`, as JAX's `init_or_load_params`
    loads it); else the reference checkpoint's files
    (`load_reference_checkpoint`, fp32); else None, when it names no
    checkpoint or one without weights: the model is then drawn from
    `--seed`."""
    path = args.model_name_or_path
    if not path:
        logger.info("initializing weights from seed %d", args.seed)
        return None
    tree = jax_params_file(path) if os.path.isdir(path) else None
    if tree is not None:
        weights = weights_from_jax(load_jax_params(tree), config)
    else:
        try:
            weights = load_reference_checkpoint(path, config)
        except FileNotFoundError:
            logger.info("no weights under %s: initializing from seed %d", path, args.seed)
            return None
    logger.info("loaded weights from %s", tree or path)
    return weights


# each graft's flag and the subtree it replaces
_GRAFTS = (("vision_path", "vision_model"), ("llm_path", "language_model"), ("mlp_path", "mlp1"))


def graft_weights(args, config: AssessorConfig) -> Optional[Dict[str, torch.Tensor]]:
    """The weights of the `--vision_path` / `--llm_path` / `--mlp_path`
    parts (JAX's `_graft_subcheckpoints`), or None without them. Each part
    is a JAX tree file (`load_jax_params`: `.msgpack` or `.safetensors`),
    with or without the `params` level; its subtree (`vision_model`,
    `language_model`, `mlp1`) sits under that name or is the whole part, as
    `part.get(name, part)` takes it; the mlp part also replaces `motion_mlp`
    where it holds one."""
    out: Dict[str, torch.Tensor] = {}
    for flag, name in _GRAFTS:
        path = getattr(args, flag, None)
        if not path:
            continue
        part = load_jax_params(path)
        part = part.get("params", part)
        tree = {name: part.get(name, part)}
        if name == "mlp1" and part.get("motion_mlp") is not None:
            tree["motion_mlp"] = part["motion_mlp"]
        out.update(weights_from_jax(tree, config, parts=tuple(tree)))
        logger.info("grafted %s from %s", "/".join(tree), path)
    return out or None


def config_and_tokenizer(args, stage: int) -> Tuple[AssessorConfig, AIGVTokenizer]:
    """The config from the flags and the checkpoint (`config_from_args`),
    with the tokenizer's `<IMG_CONTEXT>` id, and the tokenizer."""
    config = config_from_args(args, stage)
    tokenizer = load_tokenizer(args, config)
    return config.replace(img_context_token_id=int(tokenizer.img_context_token_id)), tokenizer


def mesh_config_from_args(args, world: Optional[int] = None) -> MeshConfig:
    """The mesh the flags ask for over `world` ranks (the process group's by
    default); ValueError where it does not cover them."""
    world = process_count() if world is None else world
    data = args.mesh_data or max(1, world // (args.mesh_fsdp * args.mesh_tensor))
    return check_mesh(MeshConfig(data=data, fsdp=args.mesh_fsdp, tensor=args.mesh_tensor), world)


def mesh_from_args(args):
    """The flags' `DeviceMesh` over the process group, or None for a
    single-process run (whose flags must then describe one device)."""
    config = mesh_config_from_args(args)
    return make_mesh(config) if torch.distributed.is_initialized() else None


def build_model_and_tokenizer(
    args, stage: int, *, w8a8: bool = False, int8: bool = False, int4: bool = False,
    kv_int8: bool = False,
) -> Tuple[AssessorConfig, AIGVAssessor, AIGVTokenizer]:
    """(config, model, tokenizer) from the CLI flags, as the JAX
    `build_model_and_tokenizer` assembles them: the config from the flags and
    the checkpoint, the img_context token id from the tokenizer, the weights
    from `model_weights` with the `graft_weights` parts over them, the model
    from `build_serving_model` on
    `args.device` in bf16 (fp32 with `--bf16 False`) in the quantized mode
    asked for, its adapters (a stage-2 checkpoint's, or the seed's) live,
    as JAX's eval keeps them; the W8A8 feeds picked by `AIGV_FUSE_QUANT` /
    `AIGV_QUANT_ROWS`, off where an adapter reads the float activation."""
    config, tokenizer = config_and_tokenizer(args, stage)
    precision = dataclasses.replace(
        Precision() if args.bf16 else Precision.fp32(),
        fuse_quant=quant_components("AIGV_FUSE_QUANT"),
        quant_rows=quant_components("AIGV_QUANT_ROWS"),
    )
    model = build_serving_model(config, device=args.device, precision=precision,
                                seed=args.seed, weights=model_weights(args, config),
                                w8a8=w8a8, int8=int8, int4=int4, kv_int8=kv_int8,
                                grafts=graft_weights(args, config))
    return config, model, tokenizer


def serving_args(model_name_or_path: str = "", model_scale: str = "auto",
                 max_seq_length: int = 4096, bf16: bool = True,
                 device: torch.device | str = "cuda") -> SimpleNamespace:
    """The flags the serving CLIs assemble a model from: these, and the
    training CLIs' defaults for the others, no adapters, seed 0."""
    return SimpleNamespace(
        model_name_or_path=model_name_or_path,
        model_scale=model_scale,
        max_seq_length=max_seq_length,
        down_sample_ratio=0.5,
        ps_version="v2",
        vision_select_layer=-1,
        conv_style="internlm2-chat",
        max_dynamic_patch=6,
        min_dynamic_patch=1,
        dynamic_image_size=True,
        use_thumbnail=True,
        pad2square=False,
        use_backbone_lora=0,
        use_llm_lora=0,
        drop_path_rate=0.0,
        force_image_size=448,
        seed=0,
        bf16=bf16,
        device=device,
    )


def build_serving_stack(
    model_name_or_path: str = "",
    model_scale: str = "auto",
    max_seq_length: int = 4096,
    bf16: bool = True,
    int8: bool = False,
    int4: bool = False,
    kv_int8: bool = False,
    w8a8: bool = False,
    stage: int = 2,
    device: torch.device | str = "cuda",
) -> Tuple[AssessorConfig, AIGVAssessor, AIGVTokenizer]:
    """(config, model, tokenizer) for the serving CLIs:
    `build_model_and_tokenizer` on `serving_args`, as the JAX CLI
    initialises a checkpoint without weights."""
    args = serving_args(model_name_or_path, model_scale, max_seq_length, bf16, device)
    return build_model_and_tokenizer(args, stage, w8a8=w8a8, int8=int8, int4=int4,
                                     kv_int8=kv_int8)
