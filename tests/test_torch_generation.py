"""The port's generation and shared-prefix scoring against the JAX package,
on the CPU in fp32, on one set of weights (`state_dict_from_jax`).

- `generate`, greedy: the same token ids as JAX's `generate` (unpadded and
  left-padded batches, a row that stops at eos, `with_motion` both ways).
  Both keep a bf16 cache under the fp32 model, as JAX's `generate` does.
- sampling: held by its masks and by determinism under a fixed generator
  (`jax.random` and `torch.Generator` cannot give the same draws).
- `build_query`, the conversation templates and `expand_image_tokens`:
  string for string; `chat`, `batch_chat`, `stream_chat` with the JAX
  package's test tokenizer: the same responses.
- `score_perspectives(shared_prefix_len=)` against JAX's at 2e-4 and against
  the port's own unshared path at 1e-4 (another attention path over the same
  function); `compute_shared_prefix_len` over its guards; `score_chunks` with
  `shared_prefix=True` end to end.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aigv_assessor_torch.cli.score import (
    build_serving_model,
    compute_shared_prefix_len,
    score_chunks,
)
from aigv_assessor_torch.core.config import AssessorConfig as TorchConfig
from aigv_assessor_torch.core.precision import Precision as TorchPrecision
from aigv_assessor_torch.data import conversation as t_conv
from aigv_assessor_torch.data.preprocess import expand_image_tokens as t_expand
from aigv_assessor_torch.models import generation as t_gen
from aigv_assessor_torch.models.assessor import AIGVAssessor as TorchAssessor
from aigv_assessor_torch.models.loading import state_dict_from_jax
from aigv_assessor_tpu.cli.common import compute_shared_prefix_len as j_prefix_len
from aigv_assessor_tpu.core.config import AssessorConfig
from aigv_assessor_tpu.core.precision import Precision
from aigv_assessor_tpu.data import conversation as j_conv
from aigv_assessor_tpu.data.preprocess import expand_image_tokens as j_expand
from aigv_assessor_tpu.data.tokenizer import build_test_tokenizer
from aigv_assessor_tpu.models import generation as j_gen
from aigv_assessor_tpu.models.assessor import AIGVAssessor
from aigv_assessor_tpu.ops.preprocess import resize_normalize

T = 4  # frames per video
TOL = 2e-4


@pytest.fixture(scope="module")
def setup():
    """(tokenizer, JAX model, JAX params, port model, JAX config)."""
    tok = build_test_tokenizer(model_max_length=512)
    over = dict(vocab_size=tok.vocab_size, eos_token_id=tok.eos_token_id,
                pad_token_id=tok.pad_token_id)
    cfg = AssessorConfig.tiny(stage=2)
    cfg = cfg.replace(img_context_token_id=int(tok.img_context_token_id),
                      llm=dataclasses.replace(cfg.llm, **over))
    tcfg = TorchConfig.tiny(stage=2)
    tcfg = tcfg.replace(img_context_token_id=int(tok.img_context_token_id),
                        llm=dataclasses.replace(tcfg.llm, **over))
    model = AIGVAssessor(cfg, Precision.fp32())
    ids = jnp.zeros((1, T * cfg.num_image_token + 9), jnp.int32)
    px = jnp.zeros((1, T, 56, 56, 3), jnp.float32)
    params = jax.device_get(jax.jit(model.init)(jax.random.key(0), ids, px))
    port = TorchAssessor(tcfg, TorchPrecision.fp32())
    port.load_state_dict(state_dict_from_jax(params, tcfg), strict=True)
    return tok, model, params, port.eval(), cfg


def _pixels(b, seed):
    return np.random.default_rng(seed).normal(size=(b, T, 56, 56, 3)).astype(np.float32)


def _mm_prompt(cfg, b, text, seed):
    """[B, N] ids: one token, every context slot, then `text` tokens."""
    n_ctx = T * cfg.num_image_token + 1
    ids = np.random.default_rng(seed).integers(5, cfg.llm.vocab_size, (b, 1 + n_ctx + text))
    ids = ids.astype(np.int32)
    ids[ids == cfg.img_context_token_id] = 5
    ids[:, 1 : 1 + n_ctx] = cfg.img_context_token_id
    return ids


# ------------------------------------------------------------------ generate --


@pytest.mark.parametrize("with_motion", [True, False])
def test_generate_greedy_matches_jax_multimodal(setup, with_motion):
    tok, model, params, port, cfg = setup
    ids, px = _mm_prompt(cfg, 2, 6, seed=1), _pixels(2, 2)
    gcfg = dict(max_new_tokens=5, eos_token_id=-1)  # never stops
    want = j_gen.generate(model, params, tok, ids, px, gcfg=j_gen.GenerationConfig(**gcfg),
                          with_motion=with_motion)
    got = t_gen.generate(port, tok, ids, px, gcfg=t_gen.GenerationConfig(**gcfg),
                         with_motion=with_motion)
    assert got.shape == (2, 5) and got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_generate_left_padded_batch_matches_jax_and_unpadded(setup):
    """Left padding through attention_mask -> position_ids, start_pos and
    kv_mask: a padded row decodes what it decodes alone."""
    tok, model, params, port, cfg = setup
    rng = np.random.default_rng(3)
    long_p = rng.integers(5, cfg.llm.vocab_size, (1, 12)).astype(np.int32)
    short_p = rng.integers(5, cfg.llm.vocab_size, (1, 7)).astype(np.int32)
    ids = np.full((2, 12), tok.pad_token_id, np.int32)
    mask = np.zeros((2, 12), np.int32)
    ids[0], mask[0] = long_p[0], 1
    ids[1, 5:], mask[1, 5:] = short_p[0], 1
    gcfg = dict(max_new_tokens=4, eos_token_id=-1)
    want = j_gen.generate(model, params, tok, ids, attention_mask=mask,
                          gcfg=j_gen.GenerationConfig(**gcfg))
    got = t_gen.generate(port, tok, ids, attention_mask=mask,
                         gcfg=t_gen.GenerationConfig(**gcfg))
    np.testing.assert_array_equal(got, want)
    alone = t_gen.generate(port, tok, short_p, gcfg=t_gen.GenerationConfig(**gcfg))
    np.testing.assert_array_equal(got[1:], alone)


def test_generate_row_stops_at_eos(setup):
    """A row that meets eos is eos from there on, in both packages; the other
    row goes on. The loop's stop test every few tokens changes no id."""
    tok, model, params, port, cfg = setup
    ids = np.random.default_rng(4).integers(5, cfg.llm.vocab_size, (2, 9)).astype(np.int32)
    free = t_gen.generate(port, tok, ids, gcfg=t_gen.GenerationConfig(max_new_tokens=6,
                                                                      eos_token_id=-1))
    eos = int(free[0, 2])
    if eos in free[1]:
        pytest.fail("pick another seed: the eos token also occurs in the second row")
    gcfg = dict(max_new_tokens=6, eos_token_id=eos)
    want = j_gen.generate(model, params, tok, ids, gcfg=j_gen.GenerationConfig(**gcfg))
    got = t_gen.generate(port, tok, ids, gcfg=t_gen.GenerationConfig(**gcfg))
    np.testing.assert_array_equal(got, want)
    first = free[0].tolist().index(eos)
    assert (got[0, first:] == eos).all() and (got[0, :first] == free[0, :first]).all()
    np.testing.assert_array_equal(got[1], free[1])
    # every row finished at once: the loop stops early, the rest stays eos
    both = t_gen.generate(port, tok, ids[:1], gcfg=t_gen.GenerationConfig(**gcfg))
    np.testing.assert_array_equal(both, got[:1])
    every = t_gen.decode_loop(
        port, torch.tensor([eos]), None, torch.tensor([9]), None, t_gen.GenerationConfig(**gcfg))
    assert (every == eos).all()  # finished before the first step: no decode_step ran


def test_generate_under_kv_int8_runs_the_int8_cache(setup):
    tok, _, _, port, cfg = setup
    qport = TorchAssessor(port.config, dataclasses.replace(port.precision, kv_int8=True))
    qport.load_state_dict(port.state_dict())
    ids = np.random.default_rng(5).integers(5, cfg.llm.vocab_size, (2, 9)).astype(np.int32)
    gcfg = t_gen.GenerationConfig(max_new_tokens=4, eos_token_id=-1)
    got = t_gen.generate(qport.eval(), tok, ids, gcfg=gcfg)
    assert got.shape == (2, 4) and (got >= 0).all() and (got < cfg.llm.vocab_size).all()


def test_sampling_masks_and_determinism(setup):
    logits = torch.from_numpy(np.random.default_rng(6).normal(size=(64, 50)).astype(np.float32))
    greedy = t_gen._sample_token(logits, None, t_gen.GenerationConfig())
    assert torch.equal(greedy, logits.argmax(-1))
    gen = torch.Generator().manual_seed(0)
    # a tiny temperature is greedy
    cold = t_gen._sample_token(logits, gen, t_gen.GenerationConfig(do_sample=True,
                                                                   temperature=1e-4))
    assert torch.equal(cold, greedy)
    # top-k leaves k candidates
    k3 = t_gen.GenerationConfig(do_sample=True, top_k=3, temperature=5.0)
    top3 = logits.topk(3, dim=-1).indices
    seen = set()
    for _ in range(20):
        draw = t_gen._sample_token(logits, gen, k3)
        assert (draw[:, None] == top3).any(dim=1).all()
        seen.update(draw.tolist())
    assert len(seen) > 3  # and it does draw
    # a fixed generator gives the same draws
    a = t_gen._sample_token(logits, torch.Generator().manual_seed(7),
                            t_gen.GenerationConfig(do_sample=True))
    b = t_gen._sample_token(logits, torch.Generator().manual_seed(7),
                            t_gen.GenerationConfig(do_sample=True))
    assert torch.equal(a, b)


def test_generate_sampled_is_a_function_of_its_generator(setup):
    tok, _, _, port, cfg = setup
    ids = np.random.default_rng(8).integers(5, cfg.llm.vocab_size, (2, 8)).astype(np.int32)
    gcfg = t_gen.GenerationConfig(max_new_tokens=5, eos_token_id=-1, do_sample=True, top_k=8)
    runs = [t_gen.generate(port, tok, ids, gcfg=gcfg,
                           generator=torch.Generator().manual_seed(seed)) for seed in (1, 1, 2)]
    np.testing.assert_array_equal(runs[0], runs[1])
    assert not np.array_equal(runs[0], runs[2])
    default = [t_gen.generate(port, tok, ids, gcfg=gcfg) for _ in range(2)]
    np.testing.assert_array_equal(*default)  # seeded with 0 when none is given


# ------------------------------------------------------- prompts and chat --


@pytest.mark.parametrize("name", ["internlm2-chat", "phi3-chat", "internvl_zh", "Hermes-2"])
def test_conversation_templates_equal_jax(name):
    a, b = t_conv.get_conv_template(name), j_conv.get_conv_template(name)
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    for conv in (a, b):
        conv.append_message(conv.roles[0], "rate <image> this")
        conv.append_message(conv.roles[1], "fine")
        conv.append_message(conv.roles[0], "and now?")
        conv.append_message(conv.roles[1], None)
    assert a.get_prompt() == b.get_prompt()
    assert not t_conv.get_conv_template(name).messages  # a fresh copy each time


def test_build_query_and_expand_image_tokens_equal_jax():
    history = [("what is this <image>?", "a video"), ("sure?", "yes")]
    cases = [
        ("internlm2-chat", "How good is it?", [4], 3, None, None),
        ("internlm2-chat", "Frame1: <image>\nFrame2: <image>\nrate", [1, 1], 2, history, None),
        ("phi3-chat", "text only", [], 3, None, "be brief"),
        ("Hermes-2", "<image>\nrate", [2], 1, history[:1], None),
    ]
    for args in cases:
        assert t_gen.build_query(*args) == j_gen.build_query(*args)
    text = "a <image> b <image> c <image>"
    for counts in ([2, 1], [3, 3, 1], []):
        assert t_expand(text, counts) == j_expand(text, counts)


def test_chat_matches_jax(setup):
    tok, model, params, port, cfg = setup
    px = _pixels(1, 9)[0]
    question = "How would you rate the static quality of this video?"
    for with_motion in (True, False):
        gcfg = dict(max_new_tokens=4, eos_token_id=-1)
        want = j_gen.chat(model, params, tok, px, question,
                          gcfg=j_gen.GenerationConfig(**gcfg), with_motion=with_motion,
                          return_history=True)
        got = t_gen.chat(port, tok, px, question, gcfg=t_gen.GenerationConfig(**gcfg),
                         with_motion=with_motion, return_history=True)
        assert got == want and isinstance(got[0], str)
    # the default config stops at the template's separator
    assert isinstance(t_gen.chat(port, tok, None, "rate this video"), str)


def test_batch_chat_matches_jax(setup):
    tok, model, params, port, cfg = setup
    px = _pixels(2, 10)
    questions = ["rate this video", "rate the quality of this video please"]
    gcfg = dict(max_new_tokens=3, eos_token_id=-1)
    want = j_gen.batch_chat(model, params, tok, px, questions,
                            gcfg=j_gen.GenerationConfig(**gcfg))
    got = t_gen.batch_chat(port, tok, px, questions, gcfg=t_gen.GenerationConfig(**gcfg))
    assert got == want and len(got) == 2


def test_stream_chat_matches_jax(setup):
    tok, model, params, port, cfg = setup
    gcfg = dict(max_new_tokens=4, eos_token_id=-1)
    want = list(j_gen.stream_chat(model, params, tok, "rate this video",
                                  gcfg=j_gen.GenerationConfig(**gcfg)))
    got = list(t_gen.stream_chat(port, tok, "rate this video",
                                 gcfg=t_gen.GenerationConfig(**gcfg)))
    assert got == want and len(got) == 4
    final = t_gen.chat(port, tok, None, "rate this video", gcfg=t_gen.GenerationConfig(**gcfg))
    assert got[-1].strip() == final


# ----------------------------------------------------- shared-prefix scoring --


def _perspective_prompts(cfg, b, p, seed, suffix=9):
    """[B, P, N] ids that share one token, every context slot and two more
    tokens, then differ; perspective j is right-padded by j, which leaves each
    the four real suffix tokens its read-out needs; their masks; and the
    shared length."""
    rng = np.random.default_rng(seed)
    n_ctx = T * cfg.num_image_token + 1
    prefix = 1 + n_ctx + 2
    ids = rng.integers(5, cfg.llm.vocab_size, (b, p, prefix + suffix)).astype(np.int32)
    ids[ids == cfg.img_context_token_id] = 5
    ids[:, :, :prefix] = ids[:, :1, :prefix]
    ids[:, :, 1 : 1 + n_ctx] = cfg.img_context_token_id
    ids[:, :, prefix] = 10 + np.arange(p)  # the first suffix token differs
    mask = np.ones(ids.shape, bool)
    for j in range(p):
        if j:
            mask[:, j, -j:] = False
            ids[:, j, -j:] = cfg.llm.pad_token_id
    return ids, mask, prefix


@pytest.mark.parametrize("p", [2, 4])
@pytest.mark.parametrize("masked", [True, False])
def test_shared_prefix_scores_match_jax_and_unshared(setup, p, masked):
    _, model, params, port, cfg = setup
    ids, mask, prefix = _perspective_prompts(cfg, 2, p, seed=11 + p)
    if not masked:
        mask = None
    px = _pixels(2, 12)
    want = model.apply(
        params, jnp.asarray(ids), jnp.asarray(px), None if mask is None else jnp.asarray(mask),
        method="score_perspectives", shared_prefix_len=prefix)
    tids = torch.from_numpy(ids).long()
    tmask = None if mask is None else torch.from_numpy(mask)
    with torch.no_grad():
        got = port.score_perspectives(tids, torch.from_numpy(px), tmask,
                                      shared_prefix_len=prefix)
        unshared = port.score_perspectives(tids, torch.from_numpy(px), tmask)
    assert tuple(got.shape) == (2, p) and got.dtype == torch.float32
    assert got.abs().max() > 0  # the head is open: the comparison sees something
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got.numpy(), unshared.numpy(), rtol=1e-4, atol=1e-4)


def test_shared_prefix_rejects_a_short_suffix(setup):
    _, _, _, port, cfg = setup
    ids, mask, prefix = _perspective_prompts(cfg, 1, 2, seed=13, suffix=3)
    with pytest.raises(ValueError, match="suffix too short"):
        port.score_perspectives(torch.from_numpy(ids).long(), torch.from_numpy(_pixels(1, 1)),
                                torch.from_numpy(mask), shared_prefix_len=prefix)


def test_compute_shared_prefix_len_equals_jax_over_its_guards():
    ctx = 7
    base = [3] + [ctx] * 5 + [11, 12, 13]
    cases = {
        "usable": [base + [20, 21, 22, 23, 24], base + [30, 31, 32, 33]],
        "three_prompts": [base + [20, 21, 22, 23], base + [20, 31, 32, 33, 34],
                          base + [40, 41, 42, 43]],
        "one_prompt": [base + [20, 21, 22, 23]],
        "prefix_too_short": [[3, ctx, 5, 20, 21, 22, 23], [3, ctx, 5, 30, 31, 32, 33]],
        "no_context_token": [[3, 4, 5, 6, 8, 9, 10, 11, 20, 21, 22, 23],
                             [3, 4, 5, 6, 8, 9, 10, 11, 30, 31, 32, 33]],
        "context_after_the_prefix": [base + [20, ctx, 22, 23, 24], base + [30, ctx, 32, 33, 34]],
        "suffix_too_short": [base + [20, 21, 22], base + [30, 31, 32, 33]],
        "one_is_a_prefix_of_the_other": [base + [20, 21, 22, 23], base + [20, 21, 22, 23, 24, 25]],
    }
    want = {"usable": 9, "three_prompts": 9, "one_prompt": 0, "prefix_too_short": 0,
            "no_context_token": 0, "context_after_the_prefix": 0, "suffix_too_short": 0,
            "one_is_a_prefix_of_the_other": 0}
    for name, prompts in cases.items():
        got = compute_shared_prefix_len(prompts, ctx)
        assert got == j_prefix_len(prompts, ctx) == want[name], name
    assert compute_shared_prefix_len(cases["prefix_too_short"], ctx, min_prefix=3) == \
        j_prefix_len(cases["prefix_too_short"], ctx, min_prefix=3) == 3


def test_score_chunks_shares_the_prefix_end_to_end(setup):
    """P = 4 prompts through `score_chunks`: the default shares the prefix
    (the decoder runs with a cache), `shared_prefix=False` does not, the rows
    agree, and both agree with the JAX CLI's normalize + score."""
    _, model, params, port, cfg = setup
    ids, mask, prefix = _perspective_prompts(cfg, 1, 4, seed=14)
    videos = list(np.random.default_rng(15).integers(0, 256, (3, T, 56, 56, 3), dtype=np.uint8))
    prompts = [ids[0, j, : mask[0, j].sum()] for j in range(4)]
    assert compute_shared_prefix_len(prompts, cfg.img_context_token_id) == prefix

    cached_calls = []
    lm_forward = port.language_model.forward

    def spy(*args, **kwargs):
        cached_calls.append(kwargs.get("cache") is not None)
        return lm_forward(*args, **kwargs)

    port.language_model.forward = spy
    try:
        shared = score_chunks(port, [videos[:2], videos[2:]], ids[0], mask[0], batch_size=2)
        assert cached_calls == [False, True] * 2  # per chunk: the prefix, then the suffixes
        cached_calls.clear()
        full = score_chunks(port, [videos[:2], videos[2:]], ids[0], mask[0], batch_size=2,
                            shared_prefix=False)
        assert cached_calls == [False] * 2
    finally:
        del port.language_model.forward
    assert np.asarray(shared).shape == (3, 4)
    np.testing.assert_allclose(np.asarray(shared), np.asarray(full), rtol=1e-4, atol=1e-2)
    pv = resize_normalize(jnp.asarray(np.stack(videos)), size=56, dtype=jnp.float32)
    want = model.apply(params, jnp.asarray(np.tile(ids, (3, 1, 1))), pv,
                       jnp.asarray(np.tile(mask, (3, 1, 1))), method="score_perspectives",
                       shared_prefix_len=prefix)
    np.testing.assert_allclose(np.asarray(shared), np.asarray(want) * 100.0, rtol=TOL,
                               atol=TOL * 100.0)
    # prompts without a usable prefix fall back to full prompts
    ids2 = ids.copy()
    ids2[0, 1, 0] = ids2[0, 0, 0] + 1
    cached_calls.clear()
    port.language_model.forward = spy
    try:
        score_chunks(port, [videos[:2]], ids2[0], mask[0], batch_size=2)
    finally:
        del port.language_model.forward
    assert cached_calls == [False]


def test_build_serving_model_sets_kv_int8():
    tcfg = TorchConfig.tiny(stage=2)
    for flags in ({}, {"int8": True}, {"int4": True}, {"w8a8": True}):
        model = build_serving_model(tcfg, device="cpu", precision=TorchPrecision.fp32(),
                                    kv_int8=True, **flags)
        assert model.precision.kv_int8
        assert model.precision.int8_weights == bool(flags.get("int8"))
        assert model.precision.int4_weights == bool(flags.get("int4"))
        assert model.precision.w8a8 == bool(flags.get("w8a8"))
    assert not build_serving_model(tcfg, device="cpu").precision.kv_int8
