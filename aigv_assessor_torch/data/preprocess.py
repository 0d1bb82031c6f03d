"""Prompt text helpers (the jax-free part of
`aigv_assessor_tpu/data/preprocess.py` that generation needs)."""

from __future__ import annotations

from typing import Sequence

from aigv_assessor_torch.data.constants import (
    IMG_CONTEXT_TOKEN,
    IMG_END_TOKEN,
    IMG_START_TOKEN,
)


def expand_image_tokens(conversation: str, num_image_token_list: Sequence[int]) -> str:
    """Replace each '<image>' with <img><IMG_CONTEXT>*n</img>, in order."""
    for n in num_image_token_list:
        image_tokens = f"{IMG_START_TOKEN}{IMG_CONTEXT_TOKEN * n}{IMG_END_TOKEN}"
        conversation = conversation.replace("<image>", image_tokens, 1)
    return conversation
