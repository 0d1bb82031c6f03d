"""AIGV-Assessor composite model (`aigv_assessor_tpu/models/assessor.py`),
the stage-2 scoring and training forward.

- `vision_model` (InternViT) -> drop the class token -> pixel shuffle ->
  `mlp1` projector, per frame;
- `slowfast_model` (SlowFast-R50) -> `motion_mlp` projector, per video;
- the embeddings go into the `<IMG_CONTEXT>` slots of the prompt, the motion
  embedding into the last one;
- `language_model` (InternLM2) runs the prompt;
- `mlpscore` reads the final hidden state at (real length - 4), with ReLU
  after every layer including the last, so scores are non-negative.

Submodule and parameter names follow the JAX package, so that
`models/loading.state_dict_from_jax` maps one tree onto the other.

Under `Precision.w8a8` both towers run their projections in int8 (see
`models/vit.py`, `models/internlm2.py`).

Training (stage 2): `use_backbone_lora` / `use_llm_lora` put LoRA adapters
of that rank (alpha = 2r, `lora_dropout`) on both towers' projections;
`forward(..., mos=...)` also returns `loss = mean |score - mos|`. The module's
mode is the JAX `deterministic` switch: `train()` turns on adapter dropout
and drop path (drawn from the generator that `models/lora.set_generator`
hands in), `eval()` turns them off. SlowFast always runs without gradient
and its features are detached. The LM head is not run: the cross-entropy is
no part of the stage-2 loss.

Not ported yet (ROADMAP.md, Queue 1): stage-1 text loss, logits,
shared-prefix perspective scoring, generation, Phi-3.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from aigv_assessor_torch.core.config import AssessorConfig, LoRAConfig
from aigv_assessor_torch.core.precision import Precision
from aigv_assessor_torch.models.internlm2 import InternLM2ForCausalLM
from aigv_assessor_torch.models.motion import SlowFastR50
from aigv_assessor_torch.models.vit import InternVisionModel
from aigv_assessor_torch.ops.pixel_shuffle import pixel_shuffle
from aigv_assessor_torch.ops.splice import splice_image_embeds


class ScoreMLP(nn.Module):
    """mlpscore head; ReLU after every layer including the last."""

    def __init__(self, in_dim: int, dims):
        super().__init__()
        for i, d in enumerate(dims):
            self.add_module(f"fc{i + 1}", nn.Linear(in_dim, d))
            in_dim = d
        self.num_layers = len(dims)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # the weights may be fp32 masters under training: cast to the
        # activations' dtype, as the JAX head casts its fp32 parameters
        for i in range(self.num_layers):
            fc = getattr(self, f"fc{i + 1}")
            x = F.relu(F.linear(x, fc.weight.to(x.dtype), fc.bias.to(x.dtype)))
        return x


class ProjectorMLP(nn.Module):
    """LayerNorm (in `norm_dtype`, eps 1e-5) -> Linear -> exact (erf) GELU ->
    Linear: the mlp1 / motion_mlp shape."""

    def __init__(self, in_dim: int, out_dim: int, norm_dtype: torch.dtype):
        super().__init__()
        self.norm_dtype = norm_dtype
        self.ln = nn.LayerNorm(in_dim, eps=1e-5)
        self.fc1 = nn.Linear(in_dim, out_dim)
        self.fc2 = nn.Linear(out_dim, out_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        nd = self.norm_dtype
        x = F.layer_norm(
            x.to(nd), self.ln.normalized_shape, self.ln.weight.to(nd),
            self.ln.bias.to(nd), self.ln.eps,
        ).to(self.fc1.weight.dtype)
        return self.fc2(F.gelu(self.fc1(x)))


class AIGVAssessor(nn.Module):
    def __init__(self, config: AssessorConfig, precision: Precision = Precision(),
                 grad_checkpoint: bool = False):
        """grad_checkpoint: recompute each tower layer's activations in the
        backward (the JAX model's `remat`)."""
        super().__init__()
        if config.stage < 2:
            raise NotImplementedError(
                "stage-1 (text) forward is not ported yet (ROADMAP.md, Queue 1)"
            )
        if config.llm.architecture != "InternLM2ForCausalLM":
            raise NotImplementedError(
                f"{config.llm.architecture} is not ported yet (ROADMAP.md, Queue 1)"
            )
        self.config = config
        self.precision = precision
        c_llm = config.llm.hidden_size
        shuffle = int(round(1 / config.downsample_ratio)) ** 2
        # W8A8 covers both towers' projections; the projectors, the score
        # head, the embeddings and SlowFast stay float
        vit_lora, llm_lora = (
            LoRAConfig(r=r, alpha=2 * r, dropout=config.lora_dropout) if r else None
            for r in (config.use_backbone_lora, config.use_llm_lora)
        )
        self.vision_model = InternVisionModel(
            config.vision, precision, lora=vit_lora, grad_checkpoint=grad_checkpoint
        )
        self.language_model = InternLM2ForCausalLM(
            config.llm, precision, lora=llm_lora, grad_checkpoint=grad_checkpoint
        )
        self.mlp1 = ProjectorMLP(
            config.vision.hidden_size * shuffle, c_llm, precision.norm_dtype
        )
        self.motion_mlp = ProjectorMLP(
            config.motion.feature_dim, c_llm, precision.norm_dtype
        )
        self.slowfast_model = SlowFastR50(config.motion)
        self.mlpscore = ScoreMLP(c_llm, config.score_head_dims)

    # ------------------------------------------------------------ features --

    def extract_feature(self, pixel_values: torch.Tensor) -> torch.Tensor:
        """[N_frames, H, W, 3] -> [N_frames, num_image_token, C_llm]."""
        cfg = self.config
        vit_embeds = self.vision_model(pixel_values, select_layer=cfg.select_layer)
        vit_embeds = vit_embeds[:, 1:, :]  # drop cls
        n, l, c = vit_embeds.shape
        h = w = int(l**0.5)
        vit_embeds = pixel_shuffle(
            vit_embeds.reshape(n, h, w, c),
            scale_factor=cfg.downsample_ratio,
            ps_version=cfg.ps_version,
        )
        return self.mlp1(vit_embeds.reshape(n, -1, vit_embeds.shape[-1]))

    def extract_motion(self, frames: torch.Tensor) -> torch.Tensor:
        """[B, T, H, W, 3] -> [B, C_llm]. SlowFast runs without gradient."""
        with torch.no_grad():
            feat = self.slowfast_model(frames)
        return self.motion_mlp(feat.to(self.precision.compute_dtype))

    def _encode(self, pixel_values: torch.Tensor):
        """Per-video ViT tokens [B, T*tok, C] and motion embedding [B, C]."""
        b, t = pixel_values.shape[:2]
        frames = pixel_values.reshape((b * t,) + pixel_values.shape[2:])
        vit_embeds = self.extract_feature(frames)
        return vit_embeds.reshape(b, -1, vit_embeds.shape[-1]), self.extract_motion(
            pixel_values
        )

    def readout(
        self, hidden: torch.Tensor, attention_mask: Optional[torch.Tensor]
    ) -> torch.Tensor:
        """Hidden state at each sample's (real length + score_readout_pos),
        clipped into the sequence, with non-finite values replaced."""
        pos = self.config.score_readout_pos
        if attention_mask is None:
            row = hidden[:, pos, :]
        else:
            real_len = attention_mask.to(torch.int64).sum(dim=1)
            idx = (real_len + pos).clamp(0, hidden.shape[1] - 1)
            row = hidden[torch.arange(hidden.shape[0], device=hidden.device), idx]
        return torch.nan_to_num(row, nan=0.0, posinf=1e9, neginf=-1e9)

    def score(self, readout: torch.Tensor) -> torch.Tensor:
        return self.mlpscore(readout)[..., 0].to(self.precision.logits_dtype)

    # ------------------------------------------------------------- forward --

    def forward(
        self,
        input_ids: torch.Tensor,  # [B, N]
        pixel_values: torch.Tensor,  # [B, T, H, W, 3] normalized
        attention_mask: Optional[torch.Tensor] = None,  # [B, N], 1 = real
        mos: Optional[torch.Tensor] = None,  # [B], in the score's range
    ) -> Dict[str, torch.Tensor]:
        """Teacher-forced stage-2 forward without logits:
        {'hidden' [B, N, C], 'readout' [B, C], 'score' [B] fp32}, and with
        `mos` also 'loss' = mean |score - mos| (fp32 scalar)."""
        cfg = self.config
        vit_embeds, motion_embeds = self._encode(pixel_values)
        embeds = splice_image_embeds(
            self.language_model.embed(input_ids), input_ids, vit_embeds,
            cfg.img_context_token_id, motion_embeds,
        )
        hidden = self.language_model(embeds)
        readout = self.readout(hidden, attention_mask)
        out = {"hidden": hidden, "readout": readout, "score": self.score(readout)}
        if mos is not None:
            out["loss"] = (out["score"] - mos.to(torch.float32)).abs().mean()
        return out

    def score_perspectives(
        self,
        input_ids: torch.Tensor,  # [B, P, N]: P perspective prompts per video
        pixel_values: torch.Tensor,  # [B, T, H, W, 3] normalized
        attention_mask: Optional[torch.Tensor] = None,  # [B, P, N]
    ) -> torch.Tensor:
        """Score P prompts per video off ONE encode of its frames and motion:
        the P prompts run through the LLM as B*P sequences. Returns [B, P]
        fp32. (The JAX package can also share the prompts' common token
        prefix; that path is not ported yet.)"""
        cfg = self.config
        b, p, n = input_ids.shape
        vit_embeds, motion_embeds = self._encode(pixel_values)
        ids_flat = input_ids.reshape(b * p, n)
        embeds = splice_image_embeds(
            self.language_model.embed(ids_flat), ids_flat,
            vit_embeds.repeat_interleave(p, dim=0), cfg.img_context_token_id,
            motion_embeds.repeat_interleave(p, dim=0),
        )
        hidden = self.language_model(embeds)
        mask_flat = attention_mask.reshape(b * p, n) if attention_mask is not None else None
        return self.score(self.readout(hidden, mask_flat)).reshape(b, p)
