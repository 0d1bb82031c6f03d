"""Model configuration: copies of the JAX package's dataclasses.

The JAX package's `core/config.py` cannot be imported from here: importing
anything under `aigv_assessor_tpu` runs its package `__init__`, which pulls
in jax. These copies keep the same fields, defaults and derived properties;
`tests/test_torch_ops.py` holds them field for field against the originals.

`AssessorConfig.from_json` / `from_dict` read a checkpoint's `config.json`
in the reference's composite format (`vision_config`, `llm_config`, the
repo's `motion_config` extension and the top-level pipeline fields), as the
JAX `from_dict`s do (`aigv_assessor_tpu/core/config.py:76-78`, `:146-176`,
`:298-339`). Only the InternLM2 decoder is ported: a config whose
`architectures` names Phi-3, Llama or Qwen2 raises NotImplementedError
(ROADMAP.md, Queue 1 item 7).
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple

PORTED_ARCHITECTURES = ("", "InternLM2ForCausalLM")


def _filter_kwargs(cls, d: Dict[str, Any]) -> Dict[str, Any]:
    names = {f.name for f in dataclasses.fields(cls)}
    return {k: v for k, v in d.items() if k in names}


def _check_architecture(arch: str) -> None:
    if arch not in PORTED_ARCHITECTURES:
        raise NotImplementedError(
            f"decoder architecture {arch!r}: only InternLM2ForCausalLM is ported; Phi-3 and "
            "the Llama / Qwen2 dispatch wait for ROADMAP.md, Queue 1 item 7"
        )


@dataclass(frozen=True)
class VisionConfig:
    """InternViT-300M-class encoder config."""

    hidden_size: int = 1024
    intermediate_size: int = 4096
    num_hidden_layers: int = 24
    num_attention_heads: int = 16
    image_size: int = 448
    patch_size: int = 14
    num_channels: int = 3
    hidden_act: str = "gelu"
    # tanh-approximate GELU in the encoder MLP, as the JAX package runs it
    # (the reference InternViT uses the exact erf form)
    approximate_gelu: bool = True
    norm_type: str = "layer_norm"  # 'layer_norm' | 'rms_norm'
    layer_norm_eps: float = 1e-6
    qkv_bias: bool = True
    qk_normalization: bool = False
    drop_path_rate: float = 0.1
    dropout: float = 0.0
    attention_dropout: float = 0.0
    initializer_factor: float = 1.0
    initializer_range: float = 0.02
    use_flash_attn: bool = True
    scan_layers: bool = True

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def num_patches_per_side(self) -> int:
        return self.image_size // self.patch_size

    @property
    def num_patches(self) -> int:
        return self.num_patches_per_side**2

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "VisionConfig":
        return cls(**_filter_kwargs(cls, d))

    @classmethod
    def tiny(cls) -> "VisionConfig":
        """Small config for CPU tests."""
        return cls(
            hidden_size=32,
            intermediate_size=64,
            num_hidden_layers=2,
            num_attention_heads=4,
            image_size=56,
            patch_size=14,
            drop_path_rate=0.0,
        )


@dataclass(frozen=True)
class RopeScaling:
    type: str = "dynamic"  # 'dynamic' | 'linear' | None
    factor: float = 2.0


@dataclass(frozen=True)
class LLMConfig:
    """InternLM2-class decoder config."""

    architecture: str = "InternLM2ForCausalLM"
    vocab_size: int = 92553
    hidden_size: int = 4096
    intermediate_size: int = 14336
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 8
    hidden_act: str = "silu"
    max_position_embeddings: int = 32768
    rms_norm_eps: float = 1e-5
    rope_theta: float = 1_000_000.0
    rope_scaling: Optional[RopeScaling] = RopeScaling()
    bias: bool = False
    # per-projection overrides (None -> follow `bias`)
    qkv_bias: Optional[bool] = None
    o_bias: Optional[bool] = None
    tie_word_embeddings: bool = False
    bos_token_id: int = 1
    eos_token_id: int = 2
    pad_token_id: int = 2
    initializer_range: float = 0.02
    scan_layers: bool = True

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def num_key_value_groups(self) -> int:
        return self.num_attention_heads // self.num_key_value_heads

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "LLMConfig":
        d = dict(d)
        if d.get("architectures"):
            d["architecture"] = d["architectures"][0]
        _check_architecture(d.get("architecture", ""))
        rs = d.get("rope_scaling")
        if isinstance(rs, dict):
            d["rope_scaling"] = RopeScaling(
                type=rs.get("type", "dynamic"), factor=float(rs.get("factor", 1.0))
            )
        return cls(**_filter_kwargs(cls, d))

    @property
    def effective_qkv_bias(self) -> bool:
        return self.bias if self.qkv_bias is None else self.qkv_bias

    @property
    def effective_o_bias(self) -> bool:
        return self.bias if self.o_bias is None else self.o_bias

    @classmethod
    def tiny(cls) -> "LLMConfig":
        return cls(
            vocab_size=512,
            hidden_size=64,
            intermediate_size=128,
            num_hidden_layers=2,
            num_attention_heads=4,
            num_key_value_heads=2,
            max_position_embeddings=4096,
        )


# InternVL2-2B class: InternViT-300M + InternLM2-1.8B
# (`aigv_assessor_tpu/cli/common.py:30`)
LLM_2B = LLMConfig(
    vocab_size=92553,
    hidden_size=2048,
    intermediate_size=8192,
    num_hidden_layers=24,
    num_attention_heads=16,
    num_key_value_heads=8,
)


@dataclass(frozen=True)
class MotionConfig:
    """SlowFast-R50 motion branch config; the output feature is
    32 * (slow_width + fast_width) channels (2048 slow + 256 fast)."""

    alpha: int = 4
    slow_width: int = 64
    fast_width: int = 8
    stage_depths: Tuple[int, int, int, int] = (3, 4, 6, 3)  # R50
    fusion_kernel: int = 7
    fusion_conv_ratio: int = 2
    feature_dim: int = 2304

    @classmethod
    def tiny(cls) -> "MotionConfig":
        return cls(
            slow_width=8,
            fast_width=1,
            stage_depths=(1, 1, 1, 1),
            feature_dim=288,
        )


@dataclass(frozen=True)
class LoRAConfig:
    """LoRA adapter config: alpha = 2*r, dropout 0.05."""

    r: int = 8
    alpha: int = 16
    dropout: float = 0.05

    @property
    def scaling(self) -> float:
        return self.alpha / self.r


@dataclass(frozen=True)
class AssessorConfig:
    """Composite model config (vision + LLM + motion + projection heads)."""

    vision: VisionConfig = field(default_factory=VisionConfig)
    llm: LLMConfig = field(default_factory=LLMConfig)
    motion: MotionConfig = field(default_factory=MotionConfig)

    downsample_ratio: float = 0.5
    ps_version: str = "v2"
    select_layer: int = -1
    template: str = "internlm2-chat"
    force_image_size: Optional[int] = 448
    max_dynamic_patch: int = 6
    min_dynamic_patch: int = 1
    dynamic_image_size: bool = True
    use_thumbnail: bool = True
    pad2square: bool = False

    # stage selection: 1 = text CE loss only; 2 = + mlpscore head
    stage: int = 1
    use_backbone_lora: int = 0
    use_llm_lora: int = 0
    lora_dropout: float = 0.05

    # score head widths; ReLU after every layer including the last
    score_head_dims: Tuple[int, ...] = (1024, 256, 64, 16, 1)
    # hidden-state read-out position for the score head (len - 4)
    score_readout_pos: int = -4

    img_context_token_id: int = -1  # set from the tokenizer at run time

    @property
    def num_image_token(self) -> int:
        """Tokens per frame after pixel shuffle: (448/14)^2 * 0.5^2 = 256."""
        image_size = self.force_image_size or self.vision.image_size
        return int(
            (image_size // self.vision.patch_size) ** 2 * (self.downsample_ratio**2)
        )

    @property
    def vit_hidden_size(self) -> int:
        return self.vision.hidden_size

    @property
    def llm_hidden_size(self) -> int:
        return self.llm.hidden_size

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "AssessorConfig":
        d = dict(d)
        if "vision_config" in d:
            d["vision"] = VisionConfig.from_dict(d.pop("vision_config"))
        if "motion_config" in d:
            # the repo's extension: reference checkpoints carry no SlowFast
            # config (R50 scale, the MotionConfig default)
            md = {k: tuple(v) if isinstance(v, list) else v
                  for k, v in d.pop("motion_config").items()}
            d["motion"] = MotionConfig(**_filter_kwargs(MotionConfig, md))
        if isinstance(d.get("score_head_dims"), list):
            d["score_head_dims"] = tuple(d["score_head_dims"])
        if "llm_config" in d:
            llm_d = d.pop("llm_config")
            archs = llm_d.get("architectures") or [llm_d.get("architecture", "")]
            _check_architecture(archs[0] if archs else "")
            d["llm"] = LLMConfig.from_dict(llm_d)
        return cls(**_filter_kwargs(cls, d))

    @classmethod
    def from_json(cls, path: str) -> "AssessorConfig":
        with open(path) as f:
            return cls.from_dict(json.load(f))

    @classmethod
    def tiny(cls, stage: int = 1, **kw) -> "AssessorConfig":
        kw.setdefault("force_image_size", None)  # use vision.image_size (56)
        return cls(
            vision=VisionConfig.tiny(),
            llm=LLMConfig.tiny(),
            motion=MotionConfig.tiny(),
            stage=stage,
            score_head_dims=(32, 16, 1),
            **kw,
        )

    def replace(self, **kw) -> "AssessorConfig":
        return dataclasses.replace(self, **kw)
