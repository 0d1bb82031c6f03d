"""Shared CLI assembly (`aigv_assessor_tpu/cli/common.py`): config ->
tokenizer -> model, for the serving CLIs.

- `config_from_args`: the checkpoint's `config.json` when there is one, else
  the model scale (`tiny`, `2b`, or the 8B default), then the pipeline flags.
- `load_tokenizer`: the checkpoint's `tokenizer.json` / `tokenizer.model`,
  else the built-in test tokenizer.
- `quant_components`: JAX's `AIGV_FUSE_QUANT` / `AIGV_QUANT_ROWS` switches,
  parsed as JAX parses them ('0' none, '1' both towers, else a comma list of
  'vit' / 'llm'; unset means 'vit'). This is the only place in the port that
  reads them: the models read `Precision.fuse_quant` / `quant_rows`.
- `build_serving_model`: the model on a device in the serving precision, from
  fp32 weights (a checkpoint's, or drawn from a seed).
- `build_serving_stack`: all of the above, `(config, model, tokenizer)`.

The `--vision_path` / `--llm_path` / `--mlp_path` grafts and
position-embedding resizing are not ported (ROADMAP.md, Queue 1).
"""

from __future__ import annotations

import dataclasses
import logging
import os
from types import SimpleNamespace
from typing import FrozenSet, Mapping, Optional, Tuple

import torch

from aigv_assessor_torch.core.config import LLM_2B, AssessorConfig
from aigv_assessor_torch.core.precision import COMPONENTS, Precision
from aigv_assessor_torch.data.tokenizer import AIGVTokenizer, build_test_tokenizer
from aigv_assessor_torch.models.assessor import AIGVAssessor
from aigv_assessor_torch.models.loading import (
    init_random_,
    load_reference_checkpoint,
    quantize_for_serving,
    serving_precision,
)

__all__ = ["LLM_2B", "build_serving_model", "build_serving_stack", "config_from_args",
           "load_tokenizer", "quant_components"]

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
) -> AIGVAssessor:
    """The model on `device` in `precision.compute_dtype`, as the JAX CLI's
    `build_serving_stack` makes it: fp32 weights, `weights` (an fp32
    state_dict of `AIGVAssessor(config)`, e.g. `load_reference_checkpoint`'s)
    or else drawn by `init_random_(seed)` on the device (in a float precision
    straight into the compute dtype, the fp32 values rounded tensor by
    tensor, so that InternVL2-26B's 25.5 G values fit the card in bf16),
    quantized from those fp32 values for W8A8 (`w8a8=True` or
    `precision.w8a8`: both towers' projections) or for weight-only serving (`int8=True` / `int4=True` or the
    precision's `int8_weights` / `int4_weights`: the decoder's projections
    and the LM head; int4 first when both are set), then everything else cast
    to the compute dtype, the quantization scales kept fp32. One seed gives
    the same base weights in every precision. A quantized precision holds
    the fp32 weights while the model is built (~8.8 GB at 2B). `w8a8` with `int8` or `int4`
    raises ValueError. `kv_int8` (or `precision.kv_int8`) changes no weight:
    generation then keeps its KV cache in int8, under any of the modes above.
    The precision's `fuse_quant` / `quant_rows` pick the W8A8 feeds."""
    target = serving_precision(precision, w8a8=w8a8, int8=int8, int4=int4, kv_int8=kv_int8)
    float_precision = dataclasses.replace(
        target, w8a8=False, int8_weights=False, int4_weights=False)
    with torch.device("meta"):
        model = AIGVAssessor(config, float_precision)
    if weights is None and target == float_precision:
        # straight in the compute dtype: each tensor drawn in fp32 and stored
        # rounded, bit-equal to the fp32 model cast
        model = init_random_(model.to(precision.compute_dtype).to_empty(device=device), seed)
    elif weights is None:
        model = init_random_(model.to_empty(device=device), seed)  # fp32, for the quantizers
    else:
        model.load_state_dict({k: v.to(device, torch.float32) for k, v in weights.items()},
                              strict=True, assign=True)
    if target != float_precision:
        state = quantize_for_serving(model.state_dict(), config, int8=target.int8_weights,
                                     int4=target.int4_weights)
        del model
        with torch.device("meta"):
            model = AIGVAssessor(config, target)
        model.load_state_dict(state, strict=True, assign=True)
        del state
    return model.to(precision.compute_dtype).eval()


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
    """(config, model, tokenizer) for the serving CLIs: the training CLIs'
    assembly with inference defaults, plus the quantized serving modes. The
    weights are the checkpoint's (`load_reference_checkpoint`) when
    `model_name_or_path` holds reference-format weights, else drawn from seed
    0, as the JAX CLI initialises a checkpoint without `params.msgpack`."""
    args = SimpleNamespace(
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
    )
    config = config_from_args(args, stage)
    tokenizer = load_tokenizer(args, config)
    config = config.replace(img_context_token_id=int(tokenizer.img_context_token_id))
    weights = None
    if model_name_or_path:
        try:
            weights = load_reference_checkpoint(model_name_or_path, config)
            logger.info("loaded weights from %s", model_name_or_path)
        except FileNotFoundError:
            logger.info("no weights under %s: initializing from seed 0", model_name_or_path)
    else:
        logger.info("initializing weights from seed 0")
    precision = dataclasses.replace(
        Precision() if bf16 else Precision.fp32(),
        fuse_quant=quant_components("AIGV_FUSE_QUANT"),
        quant_rows=quant_components("AIGV_QUANT_ROWS"),
    )
    model = build_serving_model(config, device=device, precision=precision, seed=0,
                                weights=weights, int8=int8, int4=int4, w8a8=w8a8,
                                kv_int8=kv_int8)
    return config, model, tokenizer
