"""Inputs made from `--seed`: the scoring prompt, the pool of videos and the
open loop's arrival times. The same seed gives the same inputs; every seed
gives the same sizes.

- The prompt (one question): a BOS token, every frame's `<IMG_CONTEXT>`
  slots and the motion slot, then the question's text tokens, drawn from
  the ordinary vocabulary (below the special tokens) — the layout of the
  repo's `bench.py` pipeline shape: 8 frames x 256 + 1 slots and 64 text
  tokens, 2113 in all at 448 px.
- Videos: uint8 frames [T, H, W, 3] at the model's input size, uniform
  noise drawn on the device and kept in host memory, as the score CLI's
  decoder hands its frames over.
- Arrivals: the gaps are the quantiles of an exponential distribution at
  the cell's rate, the same set for every seed, in an order the seed draws:
  the load is Poisson-like and no seed brings more or fewer requests.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench import counts

SPECIAL_TOKENS_FROM = 92544  # InternLM2's added tokens (<img>, <IMG_CONTEXT>, ...)
BOS = 1


def rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) % 2**63, stream])


def prompt_ids(cfg: dict, traffic: dict, seed: int) -> np.ndarray:
    """[N] int64: BOS, the image and motion slots, the text tokens."""
    n_slots = traffic["frames"] * counts.image_tokens(cfg) + 1
    text = traffic["text_tokens"]
    vocab_text = min(cfg["llm_config"]["vocab_size"], SPECIAL_TOKENS_FROM)
    ctx = cfg["img_context_token_id"]
    words = rng(seed, 1).integers(3, vocab_text - 1, text - 1)
    words = np.where(words >= ctx, words + 1, words)  # never the context id
    return np.concatenate([[BOS], np.full(n_slots, ctx), words]).astype(np.int64)


def video_pool(cfg: dict, traffic: dict, seed: int, device) -> np.ndarray:
    """[pool, T, H, W, 3] uint8 in host memory."""
    size = cfg.get("force_image_size") or cfg["vision_config"]["image_size"]
    shape = (traffic["pool"], traffic["frames"], size, size, 3)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(rng(seed, 2).integers(2**62)))
    pool = torch.randint(0, 256, shape, generator=gen, device=device, dtype=torch.uint8)
    return pool.cpu().numpy()


def arrival_times(rate: float, seconds: float, seed: int) -> np.ndarray:
    """Send times in [0, seconds): n = rate * seconds requests whose gaps
    are exponential quantiles, shuffled by the seed."""
    n = max(1, int(round(rate * seconds)))
    q = (np.arange(n) + 0.5) / n
    gaps = -np.log1p(-q) / rate
    gaps = gaps[rng(seed, 3).permutation(n)]
    return np.cumsum(gaps) - gaps[0]


def sample(seed: int, stream: int, population: int, k: int) -> np.ndarray:
    """k distinct indices of [0, population), drawn from the seed, sorted."""
    k = min(k, population)
    return np.sort(rng(seed, stream).choice(population, size=k, replace=False))
