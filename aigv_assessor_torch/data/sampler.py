"""Samplers: a jax-free copy of `aigv_assessor_tpu/data/sampler.py`.

- `LengthGroupedSampler`: the LLaVA-style length grouping of the reference
  (shuffle, megabatches of `world * batch * 50`, each sorted by length,
  split into balanced chunks).
- `ShardedBatchSampler`: batches of indices; each of `num_processes`
  processes keeps a contiguous shard of every global batch. The port runs on
  one card, so one process keeps every batch.
"""

from __future__ import annotations

from typing import Iterator, List, Optional, Sequence

import numpy as np


def split_to_even_chunks(
    indices: Sequence[int], lengths: Sequence[int], num_chunks: int
) -> List[List[int]]:
    """Greedy balanced split (reference `train_sampler_patch.py:18-45`)."""
    if len(indices) % num_chunks != 0:
        return [list(indices[i::num_chunks]) for i in range(num_chunks)]
    num_per_chunk = len(indices) // num_chunks
    chunks = [[] for _ in range(num_chunks)]
    chunk_lengths = [0] * num_chunks
    for idx in indices:
        shortest = int(np.argmin(chunk_lengths))
        chunks[shortest].append(idx)
        chunk_lengths[shortest] += lengths[idx]
        if len(chunks[shortest]) == num_per_chunk:
            chunk_lengths[shortest] = float("inf")
    return chunks


def get_length_grouped_indices(
    lengths: Sequence[int],
    batch_size: int,
    world_size: int,
    generator: Optional[np.random.Generator] = None,
    merge: bool = True,
) -> List[int]:
    """Reference `get_length_grouped_indices` (`train_sampler_patch.py:48-65`)."""
    g = generator or np.random.default_rng()
    perm = g.permutation(len(lengths))
    mega = world_size * batch_size * 50
    megabatches = [perm[i : i + mega].tolist() for i in range(0, len(lengths), mega)]
    megabatches = [
        sorted(m, key=lambda i: lengths[i], reverse=True) for m in megabatches
    ]
    megabatches = [
        split_to_even_chunks(m, lengths, world_size) for m in megabatches
    ]
    return [i for m in megabatches for chunk in m for i in chunk]


class LengthGroupedSampler:
    def __init__(
        self,
        lengths: Sequence[int],
        batch_size: int,
        world_size: int = 1,
        seed: int = 0,
    ):
        self.lengths = list(lengths)
        self.batch_size = batch_size
        self.world_size = world_size
        self.seed = seed
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __len__(self) -> int:
        return len(self.lengths)

    def __iter__(self) -> Iterator[int]:
        g = np.random.default_rng(self.seed + self.epoch)
        return iter(
            get_length_grouped_indices(
                self.lengths, self.batch_size, self.world_size, generator=g
            )
        )


class ShardedBatchSampler:
    """Yields per-process batches of indices: global batch is cut into
    `num_processes` contiguous shards; process `process_index` keeps its
    shard. Drops the trailing partial global batch (static shapes)."""

    def __init__(
        self,
        num_samples_or_sampler,
        global_batch_size: int,
        num_processes: int = 1,
        process_index: int = 0,
        shuffle: bool = True,
        seed: int = 0,
        drop_last: bool = True,
    ):
        if isinstance(num_samples_or_sampler, int):
            self._sampler = None
            self.num_samples = num_samples_or_sampler
        else:
            self._sampler = num_samples_or_sampler
            self.num_samples = len(num_samples_or_sampler)
        if global_batch_size % num_processes:
            raise ValueError(f"global batch {global_batch_size} does not split over "
                             f"{num_processes} processes")
        self.global_batch_size = global_batch_size
        self.local_batch_size = global_batch_size // num_processes
        self.num_processes = num_processes
        self.process_index = process_index
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = 0
        self.drop_last = drop_last

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch
        if self._sampler is not None and hasattr(self._sampler, "set_epoch"):
            self._sampler.set_epoch(epoch)

    def __len__(self) -> int:
        if self.drop_last:
            return self.num_samples // self.global_batch_size
        return -(-self.num_samples // self.global_batch_size)

    def __iter__(self) -> Iterator[List[int]]:
        if self._sampler is not None:
            order = list(iter(self._sampler))
        elif self.shuffle:
            order = np.random.default_rng(self.seed + self.epoch).permutation(
                self.num_samples
            ).tolist()
        else:
            order = list(range(self.num_samples))
        for start in range(0, len(order), self.global_batch_size):
            chunk = order[start : start + self.global_batch_size]
            if len(chunk) < self.global_batch_size and self.drop_last:
                break
            lo = self.process_index * self.local_batch_size
            yield chunk[lo : lo + self.local_batch_size]
