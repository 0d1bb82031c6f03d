"""AIGV-Assessor composite model (`aigv_assessor_tpu/models/assessor.py`),
the stage-1 and stage-2 scoring and training forward.

- `vision_model` (InternViT) -> drop the class token -> pixel shuffle ->
  `mlp1` projector, per frame;
- `slowfast_model` (SlowFast-R50) -> `motion_mlp` projector, per video;
- the embeddings go into the `<IMG_CONTEXT>` slots of the prompt, the motion
  embedding into the last one;
- `language_model` (InternLM2) runs the prompt;
- `mlpscore` (stage 2 only) reads the final hidden state at (real length -
  4), with ReLU after every layer including the last, so scores are
  non-negative;
- with `labels` the LM head's fp32 logits give the shifted cross-entropy
  (`models/internlm2.cross_entropy_loss`): stage 1's loss, and stage 2's when
  no `mos` is given.

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
and its features are detached. Without `labels` or `with_logits` the LM head
is not run: the cross-entropy is no part of the stage-2 loss.

Training (stage 1): `mlp1` and `motion_mlp` train on the text loss with both
towers frozen (`train/freeze.py`); the model has no `mlpscore`, as in JAX.

Generation (`models/generation.py`) enters through `embed_multimodal`,
`prefill` and `decode_step`, which run the decoder against a `KVCache`.
`score_perspectives(shared_prefix_len=)` prefills the prompts' common token
prefix once per video and runs the P suffixes against that cache.

Not ported yet (ROADMAP.md, Queue 1): Phi-3.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from aigv_assessor_torch.core.config import AssessorConfig, LoRAConfig
from aigv_assessor_torch.core.precision import Precision
from aigv_assessor_torch.models.internlm2 import (
    InternLM2ForCausalLM,
    KVCache,
    cross_entropy_loss,
)
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
        if config.stage >= 2:
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

    def extract_motion(self, frames: torch.Tensor,
                       features: Optional[torch.Tensor] = None) -> torch.Tensor:
        """[B, T, H, W, 3] -> [B, C_llm]. SlowFast runs without gradient;
        `features` ([B, feature_dim], precomputed) takes its place."""
        if features is None:
            with torch.no_grad():
                features = self.slowfast_model(frames)
        return self.motion_mlp(features.detach().to(self.precision.compute_dtype))

    def _encode(self, pixel_values: torch.Tensor):
        """Per-video ViT tokens [B, T*tok, C] and motion embedding [B, C]."""
        b, t = pixel_values.shape[:2]
        frames = pixel_values.reshape((b * t,) + pixel_values.shape[2:])
        vit_embeds = self.extract_feature(frames)
        return vit_embeds.reshape(b, -1, vit_embeds.shape[-1]), self.extract_motion(
            pixel_values
        )

    def embed_tokens(self, input_ids: torch.Tensor) -> torch.Tensor:
        return self.language_model.embed(input_ids)

    def embed_multimodal(
        self,
        input_ids: torch.Tensor,  # [B, N]
        pixel_values: torch.Tensor,  # [B, T, H, W, 3] normalized
        with_motion: bool = True,
        motion_features: Optional[torch.Tensor] = None,  # [B, feature_dim]
    ) -> torch.Tensor:
        """Prompt embeddings with the frames' ViT embeddings in the
        `<IMG_CONTEXT>` slots. `with_motion`: the last slot takes the motion
        embedding (from `motion_features` when given, else from SlowFast);
        without it every slot takes a ViT embedding (what the reference's
        `generate()` does)."""
        b, t = pixel_values.shape[:2]
        frames = pixel_values.reshape((b * t,) + pixel_values.shape[2:])
        vit_embeds = self.extract_feature(frames)
        vit_embeds = vit_embeds.reshape(b, -1, vit_embeds.shape[-1])
        motion_embeds = (self.extract_motion(pixel_values, motion_features) if with_motion
                         else None)
        return splice_image_embeds(
            self.language_model.embed(input_ids), input_ids, vit_embeds,
            self.config.img_context_token_id, motion_embeds,
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
        labels: Optional[torch.Tensor] = None,  # [B, N], -100 = ignored
        mos: Optional[torch.Tensor] = None,  # [B], in the score's range
        position_ids: Optional[torch.Tensor] = None,  # [B, N]
        with_logits: bool = False,
        motion_features: Optional[torch.Tensor] = None,  # [B, feature_dim]
    ) -> Dict[str, torch.Tensor]:
        """Teacher-forced forward, the JAX `__call__` rule for rule
        (`aigv_assessor_tpu/models/assessor.py:239-306`): {'hidden' [B, N, C]}
        and
        - with `with_logits`, or whenever `labels` are given, 'logits'
          [B, N, V] fp32; with `labels` 'ce_loss', the shifted cross-entropy;
        - stage 2: 'readout' [B, C] and 'score' [B] fp32; 'loss' = mean
          |score - mos| with `mos`, else the cross-entropy when `labels` are
          given;
        - stage 1: 'loss' = the cross-entropy when `labels` are given.
        `motion_features` replaces SlowFast's output."""
        embeds = self.embed_multimodal(input_ids, pixel_values,
                                       motion_features=motion_features)
        with_logits = with_logits or labels is not None
        logits, hidden, _ = self.language_model(
            inputs_embeds=embeds, position_ids=position_ids, with_logits=with_logits)
        out = {"hidden": hidden}
        if with_logits:
            out["logits"] = logits
        ce = None
        if labels is not None:
            ce = out["ce_loss"] = cross_entropy_loss(logits, labels)
        if self.config.stage >= 2:
            readout = self.readout(hidden, attention_mask)
            out["readout"] = readout
            out["score"] = self.score(readout)
            if mos is not None:
                out["loss"] = (out["score"] - mos.to(torch.float32)).abs().mean()
            elif ce is not None:
                out["loss"] = ce
        elif ce is not None:
            out["loss"] = ce
        return out

    def score_perspectives(
        self,
        input_ids: torch.Tensor,  # [B, P, N]: P perspective prompts per video
        pixel_values: torch.Tensor,  # [B, T, H, W, 3] normalized
        attention_mask: Optional[torch.Tensor] = None,  # [B, P, N]
        shared_prefix_len: Optional[int] = None,
    ) -> torch.Tensor:
        """Score P prompts per video off ONE encode of its frames and motion
        -> [B, P] fp32.

        Without `shared_prefix_len` the P prompts run through the LLM as B*P
        full sequences. With it, the prompts also share their first
        `shared_prefix_len` tokens (the system turn and every image and
        motion slot; only the question after them differs): the LLM runs that
        prefix once per video, keeping each layer's k/v, and the P suffixes
        ride one sequence axis against that cache with a block-diagonal
        causal mask (`two_part_cached_attention(block_causal=)`), so no
        cache is copied per perspective. The caller's contract: the first
        `shared_prefix_len` tokens are the same in every perspective, hold
        every `<IMG_CONTEXT>` slot and are not padded
        (`cli/score.compute_shared_prefix_len`)."""
        cfg = self.config
        b, p, n = input_ids.shape
        vit_embeds, motion_embeds = self._encode(pixel_values)
        if shared_prefix_len is not None:
            return self._score_suffixes_on_shared_prefix(
                input_ids, attention_mask, vit_embeds, motion_embeds, shared_prefix_len)
        ids_flat = input_ids.reshape(b * p, n)
        embeds = splice_image_embeds(
            self.language_model.embed(ids_flat), ids_flat,
            vit_embeds.repeat_interleave(p, dim=0), cfg.img_context_token_id,
            motion_embeds.repeat_interleave(p, dim=0),
        )
        _, hidden, _ = self.language_model(inputs_embeds=embeds, with_logits=False)
        mask_flat = attention_mask.reshape(b * p, n) if attention_mask is not None else None
        return self.score(self.readout(hidden, mask_flat)).reshape(b, p)

    def _score_suffixes_on_shared_prefix(
        self,
        input_ids: torch.Tensor,  # [B, P, N]
        attention_mask: Optional[torch.Tensor],  # [B, P, N]
        vit_embeds: torch.Tensor,  # [B, tok, C]
        motion_embeds: torch.Tensor,  # [B, C]
        prefix_len: int,
    ) -> torch.Tensor:
        cfg = self.config
        b, p, n = input_ids.shape
        s_suf = n - prefix_len
        if s_suf < -cfg.score_readout_pos:
            raise ValueError("suffix too short for the score read-out position")

        # 1) the common prefix once per video, keeping the roped k/v
        prefix_ids = input_ids[:, 0, :prefix_len]
        prefix_embeds = splice_image_embeds(
            self.language_model.embed(prefix_ids), prefix_ids, vit_embeds,
            cfg.img_context_token_id, motion_embeds,
        )
        # Both passes build their rope tables from one length. The suffix
        # pass takes it from its cache's capacity, and dynamic-NTK scaling
        # changes the frequencies with the table's length: a prefix roped for
        # its own length would not match the suffix queries once the
        # capacity crosses the scaling threshold.
        rope_len = prefix_len + p * s_suf
        _, _, kv = self.language_model(
            inputs_embeds=prefix_embeds, with_logits=False, capture_kv=True, rope_len=rope_len)

        # 2) the P suffixes on one sequence axis [B, P*s_suf] against that
        # cache: block-diagonal causal among themselves, the whole prefix
        # visible. The capacity covers the suffix rows the layer loop writes
        # at [prefix_len, ...); they are never read, since old rows end at
        # index = prefix_len.
        cache = KVCache.from_prefix(kv.k, kv.v, p * s_suf)
        suffix_ids = input_ids[:, :, prefix_len:].reshape(b, p * s_suf)
        pos = prefix_len + torch.arange(s_suf, device=input_ids.device).repeat(p)
        _, hidden, _ = self.language_model(
            inputs_embeds=self.language_model.embed(suffix_ids),
            position_ids=pos.expand(b, p * s_suf), cache=cache, with_logits=False,
            block_causal=s_suf,
        )  # [B, P*s_suf, C]

        # 3) each perspective reads out at its (real suffix length - 4)
        if attention_mask is not None:
            real = attention_mask[:, :, prefix_len:].to(torch.int64).sum(dim=2)
        else:
            real = torch.full((b, p), s_suf, dtype=torch.int64, device=hidden.device)
        idx = torch.arange(p, device=hidden.device)[None] * s_suf + (
            real + cfg.score_readout_pos).clamp(0, s_suf - 1)
        row = hidden[torch.arange(b, device=hidden.device)[:, None], idx]  # [B, P, C]
        row = torch.nan_to_num(row, nan=0.0, posinf=1e9, neginf=-1e9)
        return self.score(row)

    # ------------------------------------------------------------ decoding --

    def prefill(
        self,
        input_embeds: torch.Tensor,  # [B, S, C]
        cache: KVCache,
        position_ids: Optional[torch.Tensor] = None,
        kv_mask: Optional[torch.Tensor] = None,
    ):
        """Run the prompt through the LLM, filling the KV cache ->
        (logits [B, S, V], hidden, cache)."""
        return self.language_model(
            inputs_embeds=input_embeds, position_ids=position_ids, cache=cache, kv_mask=kv_mask)

    def decode_step(
        self,
        token_ids: torch.Tensor,  # [B, 1]
        cache: KVCache,
        kv_mask: Optional[torch.Tensor] = None,
        position_ids: Optional[torch.Tensor] = None,
    ):
        """One autoregressive step -> (logits [B, 1, V], hidden, cache)."""
        return self.language_model(
            input_ids=token_ids, cache=cache, kv_mask=kv_mask, position_ids=position_ids)
