"""Prompt assembly and label masking: jax-free copies of
`aigv_assessor_tpu/data/preprocess.py:46-270`.

- `render_conversation`: [{'from': 'human' | 'gpt', 'value': ...}] -> the
  prompt text through the conversation template (`data/conversation.py`).
- `expand_image_tokens`: each `<image>` -> `<img>` + n x `<IMG_CONTEXT>` +
  `</img>`.
- `preprocess_internlm`: the stage-1 `input_ids` / `labels` of the
  `internlm2-chat` template, with the reference's token-count arithmetic:
  bos and every non-assistant token at -100 (`IGNORE_TOKEN_ID`), the
  sample's labels all -100 (and `mismatch` set) where the counts disagree.
- `_preprocess_turns` with its two fronts `preprocess_mpt` (Hermes-2) and
  `preprocess_phi3`: the turn-splitting maskers of the other templates.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence

import numpy as np

from aigv_assessor_torch.data.constants import (
    IGNORE_TOKEN_ID,
    IMG_CONTEXT_TOKEN,
    IMG_END_TOKEN,
    IMG_START_TOKEN,
)
from aigv_assessor_torch.data.conversation import get_conv_template
from aigv_assessor_torch.data.tokenizer import AIGVTokenizer


@dataclass
class PreprocessedSample:
    input_ids: np.ndarray  # [S] int32
    labels: np.ndarray  # [S] int32
    attention_mask: np.ndarray  # [S] bool
    mismatch: bool = False


def render_conversation(
    template_name: str,
    conversations: Sequence[Dict[str, str]],
    strip_values: bool = False,
) -> str:
    """[{'from': 'human'|'gpt', 'value': ...}] -> full prompt text. A leading
    non-human message is dropped; `strip_values` strips each message (only
    `preprocess_internlm` does, as in the reference)."""
    conv = get_conv_template(template_name)
    roles = {"human": conv.roles[0], "gpt": conv.roles[1]}
    source = list(conversations)
    if roles[source[0]["from"]] != conv.roles[0]:
        source = source[1:]
    for j, sentence in enumerate(source):
        role = roles[sentence["from"]]
        if role != conv.roles[j % 2]:
            raise ValueError("conversation roles must alternate")
        value = sentence["value"].strip() if strip_values else sentence["value"]
        conv.append_message(role, value)
    return conv.get_prompt()


def expand_image_tokens(conversation: str, num_image_token_list: Sequence[int]) -> str:
    """Replace each '<image>' with <img><IMG_CONTEXT>*n</img>, in order."""
    for n in num_image_token_list:
        image_tokens = f"{IMG_START_TOKEN}{IMG_CONTEXT_TOKEN * n}{IMG_END_TOKEN}"
        conversation = conversation.replace("<image>", image_tokens, 1)
    return conversation


def _sample(ids: List[int], target: np.ndarray, real_len: int, mismatch: bool):
    attention_mask = np.zeros(len(ids), bool)
    attention_mask[:real_len] = True
    return PreprocessedSample(input_ids=np.asarray(ids, np.int32),
                              labels=target.astype(np.int32),
                              attention_mask=attention_mask, mismatch=mismatch)


def _encode_padded(tokenizer: AIGVTokenizer, conversation: str, group_by_length: bool,
                   **kw):
    """-> (ids cut to model_max_length and, unless group_by_length, padded
    to it; the real length)."""
    max_len = tokenizer.model_max_length
    ids = tokenizer.encode(conversation, **kw)[:max_len]
    real_len = len(ids)
    if not group_by_length:
        ids = ids + [tokenizer.pad_token_id] * (max_len - len(ids))
    return ids, real_len


def preprocess_internlm(
    template_name: str,
    sources: Sequence[Sequence[Dict[str, str]]],
    tokenizer: AIGVTokenizer,
    num_image_token_list: Sequence[int],
    text_only: bool = False,
    group_by_length: bool = False,
    ds_name: str = None,
) -> List[PreprocessedSample]:
    """The `internlm2-chat` masker: each conversation rendered with stripped
    values, its images expanded, tokenized (padded to the tokenizer's
    `model_max_length` unless `group_by_length`), and everything but the
    assistant's answers masked by re-tokenized span lengths (each minus 1
    for the bos the tokenizer adds again)."""
    conv = get_conv_template(template_name)
    conversations = [render_conversation(template_name, s, strip_values=True) for s in sources]
    if not text_only:
        conversations = [expand_image_tokens(c, num_image_token_list) for c in conversations]

    max_len = tokenizer.model_max_length
    results = []
    for conversation in conversations:
        ids, real_len = _encode_padded(tokenizer, conversation, group_by_length)
        target = np.asarray(ids, np.int32).copy()

        cur_len = 1
        target[:cur_len] = IGNORE_TOKEN_ID  # bos
        parts = conversation.split(conv.roles[1])
        info = parts[0] + conv.roles[1]
        temp_len = len(tokenizer.encode(info)) - 1
        target[cur_len : cur_len + temp_len] = IGNORE_TOKEN_ID
        cur_len += temp_len

        for index in range(1, len(parts) - 1):
            part1, part2 = parts[index].split(conv.roles[0], 1)
            cur_len += len(tokenizer.encode(part1)) - 1
            part = conv.roles[0] + part2 + conv.roles[1]
            temp_len = len(tokenizer.encode(part)) - 1
            target[cur_len : cur_len + temp_len] = IGNORE_TOKEN_ID
            cur_len += temp_len
        cur_len += len(tokenizer.encode(parts[-1])) - 1

        target[cur_len:] = IGNORE_TOKEN_ID
        mismatch = cur_len < max_len and cur_len != real_len
        if mismatch:
            target[:] = IGNORE_TOKEN_ID
        results.append(_sample(ids, target, real_len, mismatch))
    return results


def _preprocess_turns(
    template_name: str,
    sources: Sequence[Sequence[Dict[str, str]]],
    tokenizer: AIGVTokenizer,
    num_image_token_list: Sequence[int],
    text_only: bool = False,
    group_by_length: bool = False,
    ds_name: str = None,
    *,
    add_bos: bool,
    turn_len_fn,
    instr_len_fn,
    start_offset: int,
    mask_endoftext: bool = False,
) -> List[PreprocessedSample]:
    """The turn-splitting masker behind `preprocess_mpt` and
    `preprocess_phi3`: turns regrouped as [system+user+gpt, user+gpt, ...]
    by splitting at the separator, each turn's instruction prefix masked by
    its re-tokenized length."""
    conv = get_conv_template(template_name)
    conversations = [render_conversation(template_name, s) for s in sources]
    if not text_only:
        conversations = [expand_image_tokens(c, num_image_token_list) for c in conversations]

    max_len = tokenizer.model_max_length
    sep = conv.sep + conv.roles[1]
    results = []
    for conversation in conversations:
        ids, real_len = _encode_padded(tokenizer, conversation, group_by_length,
                                       add_bos=add_bos)
        target = np.asarray(ids, np.int32).copy()

        turns = conversation.split(conv.sep)
        re_turns = [conv.sep.join(turns[:3])]
        for idx in range(3, len(turns), 2):
            re_turns.append(conv.sep.join(turns[idx : idx + 2]))
        cur_len = start_offset
        target[:cur_len] = IGNORE_TOKEN_ID
        if mask_endoftext:
            eot = tokenizer.convert_tokens_to_ids("<|endoftext|>")
            if eot is not None:
                target[target == eot] = IGNORE_TOKEN_ID

        def tok_len(text):
            return len(tokenizer.encode(text, add_bos=add_bos))

        for i, turn in enumerate(re_turns):
            if turn == "":
                break
            turn_len = turn_len_fn(tok_len(turn), i)
            parts = turn.split(sep)
            if len(parts) != 2:
                break
            parts[0] += sep
            instruction_len = instr_len_fn(tok_len(parts[0]), i)
            target[cur_len : cur_len + instruction_len] = IGNORE_TOKEN_ID
            cur_len += turn_len
        target[cur_len:] = IGNORE_TOKEN_ID

        mismatch = cur_len < max_len and cur_len != real_len
        if mismatch:
            target[:] = IGNORE_TOKEN_ID
        results.append(_sample(ids, target, real_len, mismatch))
    return results


def preprocess_mpt(*args, **kw) -> List[PreprocessedSample]:
    """Hermes-2 masker: no bos; every turn costs len(tokens) + 1 (the
    separator consumed by the split); the instruction prefix is its raw
    token length."""
    return _preprocess_turns(
        *args, **kw, add_bos=False, start_offset=0,
        turn_len_fn=lambda n, i: n + 1, instr_len_fn=lambda n, i: n, mask_endoftext=False,
    )


def preprocess_phi3(*args, **kw) -> List[PreprocessedSample]:
    """phi3-chat masker: bos-counted lengths (turn: raw for the first, -1
    after; instruction: -1 first, -2 after), <|endoftext|> masked, cur_len
    starting past the bos."""
    return _preprocess_turns(
        *args, **kw, add_bos=True, start_offset=1,
        turn_len_fn=lambda n, i: n if i == 0 else n - 1,
        instr_len_fn=lambda n, i: n - 1 if i == 0 else n - 2, mask_endoftext=True,
    )
