"""Vision and motion token splice (`aigv_assessor_tpu/ops/splice.py`).

Every `<IMG_CONTEXT>` slot takes the ViT row of its rank among its sample's
context slots; with motion embeddings, the LAST context slot of each sample
takes the motion embedding instead, as the reference does.
"""

from __future__ import annotations

from typing import Optional

import torch


def splice_image_embeds(
    input_embeds: torch.Tensor,  # [B, N, C]
    input_ids: torch.Tensor,  # [B, N] integer
    vit_embeds: torch.Tensor,  # [B, n_vit, C] per-sample visual tokens, in order
    img_context_token_id: int,
    motion_embeds: Optional[torch.Tensor] = None,  # [B, C]
) -> torch.Tensor:
    b, _, c = input_embeds.shape
    if vit_embeds.ndim == 2:
        vit_embeds = vit_embeds.reshape(b, -1, c)
    n_vit = vit_embeds.shape[1]

    mask = input_ids == img_context_token_id  # [B, N]
    cums = torch.cumsum(mask.to(torch.int64), dim=1)  # 1-based rank at ctx slots
    rank = (cums - 1).clamp(0, n_vit - 1)
    gathered = torch.gather(
        vit_embeds, 1, rank[:, :, None].expand(-1, -1, c)
    ).to(input_embeds.dtype)  # [B, N, C]

    if motion_embeds is None:
        return torch.where(mask[:, :, None], gathered, input_embeds)

    is_last = mask & (cums == cums[:, -1:])  # last ctx slot of each sample
    out = torch.where((mask & ~is_last)[:, :, None], gathered, input_embeds)
    motion = motion_embeds.to(input_embeds.dtype)[:, None, :]
    return torch.where(is_last[:, :, None], motion, out)
