"""Autoregressive generation (`aigv_assessor_tpu/models/generation.py`):
greedy or sampled decoding against a fixed-capacity KV cache, and the
chat-level prompt functions.

- `generate`: multimodal embed -> `prefill` into a cache of `prompt +
  max_new_tokens` rows -> `decode_loop`. Left-padded batches are handled
  through `attention_mask`: positions count real tokens, and the pad slots of
  the cache are masked out of attention (`kv_mask`). `with_motion=False`
  gives every `<IMG_CONTEXT>` slot a ViT embedding, as the reference's
  `generate()` does; `True` puts the motion embedding into the last slot, the
  video-scoring layout.
- `decode_loop`: one `decode_step` per token. The JAX loop stops on the
  device when every row has reached eos. Here the host asks the device for
  that only every few tokens, so the steps in between are enqueued
  without waiting for the card. Finished rows are forced to eos, so steps run
  after all rows have finished change nothing in the result.
- `build_query`, `chat`, `batch_chat`, `stream_chat`: template rendering,
  `<image>` expansion, left-padded batching, the response cut at the
  template's separator. They take any tokenizer object with `encode`,
  `decode`, `batch_decode`, `convert_tokens_to_ids`, `eos_token_id` and
  `pad_token_id`.

Sampling draws from an explicit `torch.Generator` on the model's device. Its
draws are not those of `jax.random` from the same seed; greedy decoding is
what the two packages have in common token for token.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from aigv_assessor_torch.data.constants import (
    IMG_CONTEXT_TOKEN,
    IMG_END_TOKEN,
    IMG_START_TOKEN,
)
from aigv_assessor_torch.data.conversation import get_conv_template
from aigv_assessor_torch.data.preprocess import expand_image_tokens
from aigv_assessor_torch.models.internlm2 import KVCache


# decode steps between two looks at `finished` on the host
STOP_CHECK_EVERY = 8


@dataclass(frozen=True)
class GenerationConfig:
    max_new_tokens: int = 64
    do_sample: bool = False
    temperature: float = 1.0
    top_k: int = 0  # 0 = off
    eos_token_id: int = 2


def _sample_token(logits: torch.Tensor, generator: Optional[torch.Generator],
                  gcfg: GenerationConfig) -> torch.Tensor:
    """[B, V] logits -> [B] token ids: the argmax, or a draw from
    softmax(logits / temperature) over the top_k logits."""
    if not gcfg.do_sample:
        return torch.argmax(logits, dim=-1)
    logits = logits / max(gcfg.temperature, 1e-6)
    if gcfg.top_k > 0:
        top = torch.topk(logits, gcfg.top_k, dim=-1).values[..., -1:]
        logits = logits.masked_fill(logits < top, float("-inf"))
    probs = torch.softmax(logits.float(), dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


def _device_of(model) -> torch.device:
    return next(model.parameters()).device


def _embed_and_prefill(model, input_ids, pixel_values, with_motion, cache, position_ids, kv_mask):
    if pixel_values is not None:
        embeds = model.embed_multimodal(input_ids, pixel_values, with_motion=with_motion)
    else:
        embeds = model.embed_tokens(input_ids)
    return model.prefill(embeds, cache, position_ids=position_ids, kv_mask=kv_mask)


def _pixels(model, pixel_values) -> Optional[torch.Tensor]:
    if pixel_values is None:
        return None
    return torch.as_tensor(pixel_values).to(_device_of(model), model.precision.compute_dtype)


@torch.inference_mode()
def decode_loop(
    model,
    first_token: torch.Tensor,  # [B]
    cache: KVCache,
    start_pos: torch.Tensor,  # [B], rope position of the first generated token
    kv_mask: torch.Tensor,  # [B, max_len] bool
    gcfg: GenerationConfig,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Greedy or sampled decode -> [B, max_new_tokens] int64 on the model's
    device, eos-padded. The host reads `finished` every STOP_CHECK_EVERY
    tokens and not in between."""
    b = first_token.shape[0]
    eos = gcfg.eos_token_id
    tokens = torch.full((b, gcfg.max_new_tokens), eos, dtype=torch.int64,
                        device=first_token.device)
    tokens[:, 0] = first_token
    finished = first_token == eos
    for i in range(gcfg.max_new_tokens - 1):
        if i % STOP_CHECK_EVERY == 0 and bool(finished.all()):
            break
        logits, _, cache = model.decode_step(
            tokens[:, i : i + 1], cache, kv_mask, position_ids=(start_pos + i)[:, None])
        nxt = _sample_token(logits[:, -1, :], generator, gcfg)
        nxt = torch.where(finished, eos, nxt)
        tokens[:, i + 1] = nxt
        finished = finished | (nxt == eos)
    return tokens


@torch.inference_mode()
def generate(
    model,
    tokenizer,
    input_ids,  # [B, S] ids (array or tensor), left-padded
    pixel_values=None,  # [B, T, H, W, 3] normalized
    attention_mask=None,  # [B, S], 1 = real token
    gcfg: Optional[GenerationConfig] = None,
    with_motion: bool = False,
    max_cache_len: Optional[int] = None,
    generator: Optional[torch.Generator] = None,
) -> np.ndarray:
    """Prefill + decode -> generated token ids [B, max_new_tokens] (int32,
    eos-padded). `generator`: on the model's device, for `do_sample`; by
    default one seeded with 0."""
    gcfg = gcfg or GenerationConfig(eos_token_id=tokenizer.eos_token_id)
    device = _device_of(model)
    if gcfg.do_sample and generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    input_ids = torch.as_tensor(input_ids).to(device, torch.int64)
    b, s = input_ids.shape
    max_len = max_cache_len or (s + gcfg.max_new_tokens)

    cache = KVCache.init(model.config.llm, b, max_len, quantized=model.precision.kv_int8,
                         device=device)
    kv_mask = torch.ones((b, max_len), dtype=torch.bool, device=device)
    if attention_mask is None:
        position_ids = None
        start_pos = torch.full((b,), s, dtype=torch.int64, device=device)
    else:
        # left padding: positions count real tokens; the pad slots of the
        # cache are masked out of attention
        am = torch.as_tensor(attention_mask).to(device, torch.int64)
        position_ids = (torch.cumsum(am, dim=1) - 1).clamp_min(0)
        start_pos = am.sum(dim=1)
        kv_mask[:, :s] = am.bool()
    logits, _, cache = _embed_and_prefill(
        model, input_ids, _pixels(model, pixel_values), with_motion, cache, position_ids, kv_mask)
    first = _sample_token(logits[:, -1, :], generator, gcfg)
    del logits
    tokens = decode_loop(model, first, cache, start_pos, kv_mask, gcfg, generator)
    return tokens.cpu().numpy().astype(np.int32)


# ------------------------------------------------------------- chat APIs ----


def build_query(
    template_name: str,
    question: str,
    num_patches_list: Sequence[int],
    num_image_token: int,
    history: Optional[List[Tuple[str, str]]] = None,
    system_message: Optional[str] = None,
) -> str:
    """Render the prompt with its image tokens expanded."""
    if num_patches_list and "<image>" not in question:
        question = "<image>\n" + question
    template = get_conv_template(template_name)
    if system_message is not None:
        template.system_message = system_message
    for old_q, old_a in history or []:
        template.append_message(template.roles[0], old_q)
        template.append_message(template.roles[1], old_a)
    template.append_message(template.roles[0], question)
    template.append_message(template.roles[1], None)
    query = template.get_prompt()
    for n in num_patches_list:
        image_tokens = IMG_START_TOKEN + IMG_CONTEXT_TOKEN * num_image_token * n + IMG_END_TOKEN
        query = query.replace("<image>", image_tokens, 1)
    return query


def _chat_config(tokenizer, template) -> GenerationConfig:
    """Stop at the template's separator where the tokenizer knows it."""
    return GenerationConfig(
        eos_token_id=tokenizer.convert_tokens_to_ids(template.sep) or tokenizer.eos_token_id)


def chat(
    model,
    tokenizer,
    pixel_values,  # [T, H, W, 3] normalized, one sample, or None
    question: str,
    gcfg: Optional[GenerationConfig] = None,
    history: Optional[List[Tuple[str, str]]] = None,
    return_history: bool = False,
    num_patches_list: Optional[List[int]] = None,
    with_motion: bool = False,
):
    """Single-sample chat -> the response, and with `return_history` also the
    history with this turn appended."""
    template = get_conv_template(model.config.template)
    if num_patches_list is None:
        num_patches_list = [pixel_values.shape[0]] if pixel_values is not None else []
    if with_motion and pixel_values is not None:
        # the video-scoring layout: one `Frame{i}: <image>` line per frame and
        # a motion slot of one token, expanded with per-image counts as the
        # training preprocessor does
        frames = pixel_values.shape[0]
        blocks = "\n".join(f"Frame{i + 1}: <image>" for i in range(frames))
        question = blocks + "\nMotion Feature: <image>\n" + question.replace("<image>", "")
        query = build_query(model.config.template, question, [], 0, history)
        query = expand_image_tokens(query, [model.config.num_image_token] * frames + [1])
    else:
        query = build_query(model.config.template, question, num_patches_list,
                            model.config.num_image_token, history)
    ids = np.asarray([tokenizer.encode(query)], np.int32)
    px = pixel_values[None] if pixel_values is not None else None
    gcfg = gcfg or _chat_config(tokenizer, template)
    out = generate(model, tokenizer, ids, px, gcfg=gcfg, with_motion=with_motion)
    response = tokenizer.decode(out[0], skip_special_tokens=True)
    response = response.split(template.sep)[0].strip()
    new_history = (history or []) + [(question, response)]
    return (response, new_history) if return_history else response


def batch_chat(
    model,
    tokenizer,
    pixel_values,  # [B, T, H, W, 3] normalized, or None
    questions: List[str],
    gcfg: Optional[GenerationConfig] = None,
    num_patches_list: Optional[List[int]] = None,
) -> List[str]:
    """Batched single-turn chat with left padding."""
    template = get_conv_template(model.config.template)
    b = len(questions)
    if num_patches_list is None:
        num_patches_list = [pixel_values.shape[1]] * b if pixel_values is not None else [0] * b
    queries = [
        build_query(model.config.template, q, [n] if n else [], model.config.num_image_token)
        for q, n in zip(questions, num_patches_list)
    ]
    encoded = [tokenizer.encode(q) for q in queries]
    max_len = max(len(e) for e in encoded)
    ids = np.full((b, max_len), tokenizer.pad_token_id, np.int32)
    mask = np.zeros((b, max_len), np.int32)
    for i, e in enumerate(encoded):  # left padding
        ids[i, max_len - len(e):] = e
        mask[i, max_len - len(e):] = 1
    gcfg = gcfg or _chat_config(tokenizer, template)
    out = generate(model, tokenizer, ids, pixel_values, attention_mask=mask, gcfg=gcfg)
    responses = tokenizer.batch_decode(out, skip_special_tokens=True)
    return [r.split(template.sep)[0].strip() for r in responses]


@torch.inference_mode()
def stream_chat(
    model,
    tokenizer,
    question: str,
    pixel_values=None,  # [T, H, W, 3] normalized, one sample
    gcfg: Optional[GenerationConfig] = None,
    history: Optional[List[Tuple[str, str]]] = None,
    with_motion: bool = False,
):
    """Streaming `chat`: yields the partial response after every generated
    token (greedy). The host reads each token before the next step starts:
    for interactive use; batches go through `generate`."""
    template = get_conv_template(model.config.template)
    gcfg = gcfg or _chat_config(tokenizer, template)
    num_patches_list = [pixel_values.shape[0]] if pixel_values is not None else []
    query = build_query(model.config.template, question, num_patches_list,
                        model.config.num_image_token, history)
    device = _device_of(model)
    ids = torch.as_tensor([tokenizer.encode(query)], dtype=torch.int64, device=device)
    s = ids.shape[1]
    cache = KVCache.init(model.config.llm, 1, s + gcfg.max_new_tokens,
                         quantized=model.precision.kv_int8, device=device)
    px = pixel_values[None] if pixel_values is not None else None
    logits, _, cache = _embed_and_prefill(
        model, ids, _pixels(model, px), with_motion, cache, None, None)
    token = int(torch.argmax(logits[0, -1]))
    generated: List[int] = []
    for i in range(gcfg.max_new_tokens):
        if token == gcfg.eos_token_id:
            break
        generated.append(token)
        yield tokenizer.decode(generated, skip_special_tokens=True).split(template.sep)[0]
        logits, _, cache = model.decode_step(
            torch.tensor([[token]], dtype=torch.int64, device=device), cache,
            position_ids=torch.tensor([[s + i]], dtype=torch.int64, device=device))
        token = int(torch.argmax(logits[0, -1]))
