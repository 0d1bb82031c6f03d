"""Batch collation: a jax-free copy of `aigv_assessor_tpu/data/collator.py`.

As the reference's `concat_pad_data_collator`: input_ids right-padded with
`pad_id` (0), labels with -100, the attention mask recomputed, the frames
stacked per sample. Sequences pad to `pad_to` or to the longest sample
rounded up to `seq_multiple` (128), the JAX package's length buckets, so
the port's batches have the JAX batches' shapes.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence

import numpy as np

from aigv_assessor_torch.data.dataset import Sample

IGNORE = -100


@dataclass
class Batch:
    """A numpy batch and its host-side metadata."""

    input_ids: np.ndarray  # [B, S] int32
    labels: np.ndarray  # [B, S] int32
    attention_mask: np.ndarray  # [B, S] bool
    pixel_values: np.ndarray  # [B, T, H, W, 3] float32
    image_flags: np.ndarray  # [B, T] int32
    mos: np.ndarray  # [B] float32
    video_names: Optional[list] = None
    answers: Optional[list] = None

    def arrays(self) -> Dict[str, np.ndarray]:
        return {
            "input_ids": self.input_ids,
            "labels": self.labels,
            "attention_mask": self.attention_mask,
            "pixel_values": self.pixel_values,
            "image_flags": self.image_flags,
            "mos": self.mos,
        }


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def collate(
    samples: Sequence[Sample],
    pad_to: Optional[int] = None,
    seq_multiple: int = 128,
    pad_id: int = 0,
) -> Batch:
    """Pad/stack samples.

    `pad_to=None` pads to the max sample length rounded up to `seq_multiple`
    (the JAX package's length buckets); the reference pads input_ids with 0 and
    labels with -100 (`pad_data_collator.py:57-76`).
    """
    max_len = max(len(s.input_ids) for s in samples)
    target = pad_to if pad_to is not None else _round_up(max_len, seq_multiple)
    b = len(samples)
    t = max(s.pixel_values.shape[0] for s in samples)

    input_ids = np.full((b, target), pad_id, np.int32)
    labels = np.full((b, target), IGNORE, np.int32)
    attn = np.zeros((b, target), bool)
    px_shape = samples[0].pixel_values.shape[1:]
    pixel_values = np.zeros((b, t) + px_shape, np.float32)
    image_flags = np.zeros((b, t), np.int32)
    mos = np.zeros((b,), np.float32)

    for i, s in enumerate(samples):
        n = min(len(s.input_ids), target)
        input_ids[i, :n] = s.input_ids[:n]
        labels[i, :n] = s.labels[:n]
        attn[i, :n] = s.attention_mask[:n]
        ft = s.pixel_values.shape[0]
        pixel_values[i, :ft] = s.pixel_values
        image_flags[i, :ft] = s.image_flags
        mos[i] = s.mos

    return Batch(
        input_ids=input_ids,
        labels=labels,
        attention_mask=attn,
        pixel_values=pixel_values,
        image_flags=image_flags,
        mos=mos,
        video_names=[s.video_name for s in samples],
        answers=[s.answer for s in samples],
    )
