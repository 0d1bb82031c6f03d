"""LoRA adapters over quantized bases, and the QK-normalized tower
quantized: the port against the JAX package on the CPU, in fp32.

- One adapted layer: `W8A8Linear`, `Int8Linear` and `Int4Linear` with an
  adapter whose `lora_b` is drawn non-zero, against `LoRADense(w8a8 | int8 |
  int4, lora=...)` on the same int8 weights and inputs from a numpy seed, in
  every form JAX has for the base (W8A8: plain, head-major out, head-major
  in; int8 / int4: plain) and in the port's row-major call beside the
  head-major one. Tolerance OP_TOL: the same products in another order
  (the int8 values of x are equal, `tests/test_torch_w8a8.py`).
- The tiny model with rank-2 adapters live (non-zero `lora_b`) under fp32,
  W8A8, int8 and int4: one JAX fp32 tree, quantized by JAX's
  `quantize_for_serving` and mapped into the port: the forward's hidden
  state and score, shared-prefix perspective scores (the prefix's
  `capture_kv` and the suffix pass against the cache, both through the
  adapters) and a prefill with decode steps. Tolerances as
  tests/test_torch_w8a8.py and tests/test_torch_fused_feeds.py hold the
  slice without adapters.
- Each mode's distance to the fp32 forward, the port's against JAX's, and
  the int8 / int4 quantizers' error on N(0, 0.02) weights at K = 2048 (why
  int4 sits far from fp32 on random weights).
- The QK-normalized tower (InternViT-6B's layer at 5 heads, the config of
  tests/test_torch_qknorm.py) with adapters under W8A8 (dense int8 qkv and
  proj, RMSNorm feeds unfused), int8 and int4 (the tower float): the ViT's
  output and the forward's score.

The scores are read from a score head made non-negative, so that the
readout reaches them. Each JAX reference is made once per module and
shared: the fp32 tree of each config (one jitted init), each mode's pair,
and the teacher-forced JAX forward that the forward and distance tests both
read.
"""

from tests import _torch_threads  # noqa: F401  (before torch does work)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aigv_assessor_torch.core.config import AssessorConfig as TorchConfig
from aigv_assessor_torch.core.config import LoRAConfig as TorchLoRAConfig
from aigv_assessor_torch.core.precision import Precision as TorchPrecision
from aigv_assessor_torch.models.assessor import AIGVAssessor as TorchAssessor
from aigv_assessor_torch.models.internlm2 import KVCache as TorchKVCache
from aigv_assessor_torch.models.loading import state_dict_from_jax
from aigv_assessor_torch.models.lora import Int4Linear, Int8Linear, W8A8Linear, make_linear
from aigv_assessor_torch.ops import int8_matmul as two
from aigv_assessor_tpu.core.config import AssessorConfig, LoRAConfig
from aigv_assessor_tpu.core.precision import Precision
from aigv_assessor_tpu.models.assessor import AIGVAssessor
from aigv_assessor_tpu.models.internlm2 import KVCache
from aigv_assessor_tpu.models.loading import quantize_for_serving as jax_quantize_for_serving
from aigv_assessor_tpu.models.lora import LoRADense
from aigv_assessor_tpu.tools import convert_to_int8 as c8

OP_TOL = 1e-5  # one layer's fp32 outputs
TOL = 2e-4  # the slice's hidden state (tests/test_torch_w8a8.py)
SCORE_ATOL = 1e-3  # scores (tests/test_torch_w8a8.py)
# the W8A8 ViT: XLA's and PyTorch's tanh differ by an ulp, which can move a
# GELU output's int8 value and the next rows' scales (tests/test_torch_w8a8.py)
VIT_REL_L2 = 5e-3
# prefill + decode logits under W8A8: a last-bit difference can flip an int8
# value (tests/test_torch_fused_feeds.py)
DECODE_TOL = 2e-3
# a mode's distance to the fp32 forward, the port's against JAX's, relative
DIST_TOL = 1e-2
CTX = 7
T = 4
TEXT = 16
R = 2
MODES = ("fp32", "w8a8", "int8", "int4")
QK_VISION = dict(hidden_size=40, intermediate_size=64, num_attention_heads=5,
                 norm_type="rms_norm", qk_normalization=True, qkv_bias=False,
                 initializer_factor=0.1)


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))  # a writable copy


def _rel_l2(got, want) -> float:
    got, want = np.float64(got.detach().numpy()), np.float64(np.asarray(want))
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=tol, atol=tol)


# ------------------------------------------------------------ one layer ---

B, S, HEADS, D, OUT_HEADS = 2, 20, 4, 8, 6
C = HEADS * D
LAYERS = {"w8a8": W8A8Linear, "int8": Int8Linear, "int4": Int4Linear}
# (base, form): JAX's forms for the base, and the row-major call of a layer
# built head-major
FORMS = [("w8a8", "plain"), ("w8a8", "head_major_out"), ("w8a8", "head_major_in"),
         ("w8a8", "rows"), ("int8", "plain"), ("int8", "rows"), ("int4", "plain"),
         ("int4", "rows")]


def _layer_case(base, form, seed=0):
    """-> (port layer, JAX LoRADense, its params, x, out features)."""
    rng = np.random.default_rng(seed)
    out = OUT_HEADS * D if form in ("head_major_out", "rows") else 24
    in_ = C + 1 if base == "int4" else C  # an odd K: int4 packs a half byte
    if form == "head_major_in":
        x = rng.normal(size=(B, HEADS, S, D))
    else:
        x = rng.normal(size=(B, S, in_))
    kernel = rng.normal(0, 0.2, (in_, out)).astype(np.float32)
    bias = rng.normal(0, 0.2, (out,)).astype(np.float32)
    lora_a = rng.normal(0, 0.3, (in_, R)).astype(np.float32)
    lora_b = rng.normal(0, 0.3, (R, out)).astype(np.float32)
    port_kw = dict(heads=OUT_HEADS if form in ("head_major_out", "rows") else None,
                   head_major_in=form == "head_major_in")
    layer = LAYERS[base](in_, out, True, out_dtype=torch.float32,
                         lora=TorchLoRAConfig(r=R, alpha=2 * R, dropout=0.0), **port_kw)
    layer.load_float_weight_(torch.from_numpy(kernel.T.copy()))
    with torch.no_grad():
        layer.bias.copy_(_t(bias))
        layer.lora_a.copy_(_t(lora_a))
        layer.lora_b.copy_(_t(lora_b))
    w = layer.weight.numpy().T  # the JAX layout [ceil(in / packing), out]
    names = {"int4": ("kernel_int4", "kernel_scale4")}.get(base, ("kernel_int8", "kernel_scale"))
    params = {"params": {"base": {names[0]: w, names[1]: layer.weight_scale.numpy(),
                                  "bias": bias},
                         "lora_a": lora_a, "lora_b": lora_b}}
    jax_kw = {base: True}
    if form == "head_major_out":
        jax_kw["head_major"] = OUT_HEADS
    elif form == "head_major_in":
        jax_kw["head_major_in"] = True
    dense = LoRADense(out, use_bias=True, dtype=jnp.float32,
                      lora=LoRAConfig(r=R, alpha=2 * R, dropout=0.0), **jax_kw)
    return layer.eval(), dense, params, x.astype(np.float32), out


@pytest.mark.parametrize("base,form", FORMS, ids=[f"{b}-{f}" for b, f in FORMS])
def test_adapted_quantized_layer_matches_lora_dense(base, form):
    layer, dense, params, x, out = _layer_case(base, form)
    want = dense.apply(params, jnp.asarray(x))
    with torch.no_grad():
        got = layer.rows(_t(x)) if form == "rows" else layer(_t(x))
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=OP_TOL, atol=OP_TOL)
    if form == "head_major_out":  # a view of the dense result, delta included
        assert not got.is_contiguous()
        with torch.no_grad():
            rows = layer.rows(_t(x))
        assert torch.equal(got, rows.view(B, S, OUT_HEADS, D).transpose(1, 2))
    # the adapter moves the output: merging it into the float weight before
    # quantizing would be another function
    with torch.no_grad():
        layer.lora_b.zero_()
        base_only = layer.rows(_t(x).transpose(1, 2).reshape(B, S, -1)
                               if form == "head_major_in" else _t(x))
    assert (base_only - (got.transpose(1, 2).reshape(B, S, -1) if got.ndim == 4
                         else got)).abs().max() > 1e-2


def test_an_adapted_layer_refuses_a_prequantized_input():
    """A fused quantize feed cannot serve an adapter, which reads the float
    activation: JAX asserts, the port raises; without an adapter the pair
    is taken."""
    from aigv_assessor_torch.ops.w8a8 import quantize_rows

    x = torch.randn(2, 5, 16)
    adapted = make_linear(16, 8, lora=TorchLoRAConfig(r=2),
                          precision=TorchPrecision(w8a8=True, compute_dtype=torch.float32))
    with pytest.raises(ValueError, match="float input"):
        adapted(quantize_rows(x))
    plain = make_linear(16, 8, precision=TorchPrecision(w8a8=True, compute_dtype=torch.float32))
    assert torch.equal(plain(quantize_rows(x)), plain(x))


# ----------------------------------------------------------- the slice ---


def _edit_tree(params, seed=7):
    """lora_b drawn non-zero, the score head's kernels made non-negative."""
    rng = np.random.default_rng(seed)

    def edit(path, x):
        name = str(path[-1].key)
        if name == "lora_b":
            return (rng.normal(size=x.shape) * 0.05).astype(x.dtype)
        if "mlpscore" in str(path) and name == "kernel":
            return np.abs(x)
        return x
    return jax.tree_util.tree_map_with_path(edit, params)


def _configs(qk=False):
    lora = dict(use_backbone_lora=R, use_llm_lora=R, lora_dropout=0.0)
    cfg = AssessorConfig.tiny(stage=2, **lora).replace(img_context_token_id=CTX)
    tcfg = TorchConfig.tiny(stage=2, **lora).replace(img_context_token_id=CTX)
    if qk:
        cfg = cfg.replace(vision=dataclasses.replace(cfg.vision, **QK_VISION))
        tcfg = tcfg.replace(vision=dataclasses.replace(tcfg.vision, **QK_VISION))
    return cfg, tcfg


class _References:
    """The module's JAX references, each made once: the edited fp32 tree of
    each config (one jitted init), each mode's pair, and JAX's
    teacher-forced forward that the forward and distance tests both read."""

    def __init__(self):
        self.trees, self.pairs, self.forwards = {}, {}, {}

    def tree(self, qk):
        if qk not in self.trees:
            cfg, _ = _configs(qk)
            model = AIGVAssessor(cfg, Precision.fp32())
            rng = np.random.default_rng(0)
            n = T * cfg.num_image_token + 1 + TEXT
            ids = jnp.asarray(rng.integers(10, 500, (1, n)), jnp.int32)
            px = jnp.zeros((1, T, 56, 56, 3), jnp.float32)
            self.trees[qk] = _edit_tree(
                jax.device_get(jax.jit(model.init)(jax.random.key(0), ids, px)))
        return self.trees[qk]

    def pair(self, mode, qk=False):
        """(JAX model in the mode, its params, the port model, JAX config):
        one fp32 tree with live adapters, quantized by JAX and mapped into
        the port."""
        if (mode, qk) not in self.pairs:
            cfg, tcfg = _configs(qk)
            host = jax.tree_util.tree_map(lambda x: x, self.tree(qk))  # fresh containers
            prec = Precision.fp32()
            if mode != "fp32":
                host, prec = jax_quantize_for_serving(host, prec, **{mode: True})
            tprec = TorchPrecision(compute_dtype=torch.float32, w8a8=mode == "w8a8",
                                   int8_weights=mode == "int8", int4_weights=mode == "int4")
            port = TorchAssessor(tcfg, tprec)
            port.load_state_dict(state_dict_from_jax(host, tcfg, tprec), strict=True)
            self.pairs[mode, qk] = (AIGVAssessor(cfg, prec), host, port.eval(), cfg)
        return self.pairs[mode, qk]

    def forward(self, mode):
        """JAX's forward of the mode's pair on `_forward_inputs`."""
        if mode not in self.forwards:
            model, params, _, cfg = self.pair(mode)
            ids, mask, px = _forward_inputs(cfg)
            self.forwards[mode] = model.apply(params, jnp.asarray(ids), jnp.asarray(px),
                                              jnp.asarray(mask), with_logits=False)
        return self.forwards[mode]


@pytest.fixture(scope="module")
def refs():
    return _References()


@pytest.fixture(scope="module", params=MODES)
def adapted_pair(request, refs):
    return (request.param,) + refs.pair(request.param)


def _prompt(cfg, b, seed):
    rng = np.random.default_rng(seed)
    n_ctx = T * cfg.num_image_token + 1
    n = n_ctx + TEXT
    ids = rng.integers(10, 500, (b, n)).astype(np.int32)
    ids[:, 1 : 1 + n_ctx] = CTX
    mask = np.ones((b, n), bool)
    mask[:, n - 3 :] = False
    ids[:, n - 3 :] = 2
    return ids, mask


def _forward_inputs(cfg):
    ids, mask = _prompt(cfg, 2, 4)
    px = np.random.default_rng(5).normal(size=(2, T, 56, 56, 3)).astype(np.float32)
    return ids, mask, px


def test_live_adapters_forward_matches(adapted_pair, refs):
    """The teacher-forced forward: every projection of both towers adapted
    over the mode's base (under W8A8 with every fused feed off)."""
    mode, model, params, port, cfg = adapted_pair
    quantized = [m for m in port.modules() if isinstance(m, (W8A8Linear, Int8Linear))]
    adapted = [m for m in quantized if m.lora is not None]
    assert len(adapted) == {"fp32": 0, "w8a8": 18, "int8": 10, "int4": 10}[mode]
    ids, mask, px = _forward_inputs(cfg)
    want = refs.forward(mode)
    with torch.no_grad():
        got = port(_t(ids).long(), _t(px), _t(mask))
    _close(got["hidden"], want["hidden"])
    _close(got["score"], want["score"], SCORE_ATOL)
    assert float(np.abs(np.asarray(want["score"])).max()) > 0


def _perspective_prompts(cfg, b, p, seed, suffix=9):
    """[B, P, N] ids sharing one token, every context slot and two more
    tokens; perspective j right-padded by j; and the shared length."""
    rng = np.random.default_rng(seed)
    n_ctx = T * cfg.num_image_token + 1
    prefix = 1 + n_ctx + 2
    ids = rng.integers(10, cfg.llm.vocab_size, (b, p, prefix + suffix)).astype(np.int32)
    ids[ids == CTX] = 10
    ids[:, :, :prefix] = ids[:, :1, :prefix]
    ids[:, :, 1 : 1 + n_ctx] = CTX
    ids[:, :, prefix] = 10 + np.arange(p)
    mask = np.ones(ids.shape, bool)
    for j in range(1, p):
        mask[:, j, -j:] = False
        ids[:, j, -j:] = cfg.llm.pad_token_id
    return ids, mask, prefix


def test_live_adapters_shared_prefix_scores_match(adapted_pair):
    """The shared prefix under live adapters: the prefix's k/v captured
    through the adapted wqkv, the suffixes through its row-major call
    against that cache; also equal to the unshared path."""
    _, model, params, port, cfg = adapted_pair
    ids, mask, prefix = _perspective_prompts(cfg, 2, 3, seed=13)
    px = np.random.default_rng(14).normal(size=(2, T, 56, 56, 3)).astype(np.float32)
    want = model.apply(params, jnp.asarray(ids), jnp.asarray(px), jnp.asarray(mask),
                       method="score_perspectives", shared_prefix_len=prefix)
    with torch.no_grad():
        got = port.score_perspectives(_t(ids).long(), _t(px), _t(mask),
                                      shared_prefix_len=prefix)
        unshared = port.score_perspectives(_t(ids).long(), _t(px), _t(mask))
    assert tuple(got.shape) == (2, 3) and got.abs().max() > 0
    _close(got, want, SCORE_ATOL)
    _close(got, unshared.numpy(), SCORE_ATOL)


def test_live_adapters_prefill_and_decode_steps_match(adapted_pair):
    """A KV cache under live adapters: prefill, then single-token steps."""
    mode, model, params, port, cfg = adapted_pair
    b, prompt, steps, cap = 2, 9, 2, 16
    ids = np.random.default_rng(6).integers(5, cfg.llm.vocab_size, (b, prompt + steps))
    cache = KVCache.init(cfg.llm, b, cap, dtype=jnp.float32)
    embeds = model.apply(params, jnp.asarray(ids[:, :prompt]), method="embed_tokens")
    logits, _, cache = model.apply(params, embeds, cache, method="prefill")
    want = [logits]
    for i in range(prompt, prompt + steps):
        logits, _, cache = model.apply(params, jnp.asarray(ids[:, i : i + 1]), cache,
                                       method="decode_step")
        want.append(logits)
    tcache = TorchKVCache.init(port.config.llm, b, cap, dtype=torch.float32)
    with torch.no_grad():
        embeds = port.embed_tokens(_t(ids[:, :prompt]).long())
        logits, _, tcache = port.prefill(embeds, tcache)
        got = [logits]
        for i in range(prompt, prompt + steps):
            logits, _, tcache = port.decode_step(_t(ids[:, i : i + 1]).long(), tcache)
            got.append(logits)
    tol = DECODE_TOL if mode == "w8a8" else TOL
    for g, w in zip(got, want):
        _close(g, w, tol)


@pytest.mark.parametrize("mode", ["w8a8", "int8", "int4"])
def test_qk_normalized_tower_quantized_matches(mode, refs):
    """InternViT-6B's layer under each quantized mode, adapters live: W8A8
    quantizes its dense qkv and proj and the MLP (RMSNorm feeds unfused);
    int8 / int4 leave the tower float."""
    model, params, port, cfg = refs.pair(mode, qk=True)
    w8a8_vit = [m for m in port.vision_model.modules() if isinstance(m, W8A8Linear)]
    assert len(w8a8_vit) == (8 if mode == "w8a8" else 0)
    assert all(m.heads is None and not m.head_major_in for m in w8a8_vit)
    frames = np.random.default_rng(1).normal(size=(T, 56, 56, 3)).astype(np.float32)
    want = model.apply(params, jnp.asarray(frames), method=lambda m, x: m.vision_model(x))
    with torch.no_grad():
        got = port.vision_model(_t(frames))
    assert tuple(got.shape) == want.shape
    assert _rel_l2(got, want) <= (VIT_REL_L2 if mode == "w8a8" else TOL)
    ids, mask = _prompt(cfg, 2, 4)
    px = np.random.default_rng(5).normal(size=(2, T, 56, 56, 3)).astype(np.float32)
    want = model.apply(params, jnp.asarray(ids), jnp.asarray(px), jnp.asarray(mask),
                       with_logits=False)
    with torch.no_grad():
        got = port(_t(ids).long(), _t(px), _t(mask))
    _close(got["score"], want["score"], SCORE_ATOL)


@pytest.fixture(scope="module")
def fp32_pair(refs):
    return refs.pair("fp32")


def test_live_adapters_distance_to_fp32_is_jax(adapted_pair, fp32_pair, refs):
    """Each mode's hidden state sits as far from the fp32 forward (same tree,
    adapters live) in the port as in JAX, within DIST_TOL of JAX's distance:
    the distance is the quantization's, shared by both packages (under int4
    the largest; see test_quantizer_error_on_gaussian_weights)."""
    mode, model, params, port, cfg = adapted_pair
    fmodel, fparams, fport, _ = fp32_pair
    ids, mask, px = _forward_inputs(cfg)
    jax_mode = refs.forward(mode)["hidden"]
    jax_fp32 = refs.forward("fp32")["hidden"]
    with torch.no_grad():
        port_mode = port(_t(ids).long(), _t(px), _t(mask))["hidden"]
        port_fp32 = fport(_t(ids).long(), _t(px), _t(mask))["hidden"]
    d_jax = _rel_l2(_t(jax_mode), jax_fp32)
    d_port = _rel_l2(port_mode, port_fp32.numpy())
    print(f"{mode}: hidden rel L2 to the fp32 forward, port {d_port:.4e}, JAX {d_jax:.4e}")
    assert abs(d_port - d_jax) <= DIST_TOL * d_jax + TOL


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_quantizer_error_on_gaussian_weights(mode):
    """The per-output-channel quantizers on N(0, 0.02) weights at the 2B
    decoder's K = 2048: the relative L2 error of the dequantized weight,
    the port's equal to JAX's (`tools/convert_to_int8`). The scale is the
    row's absmax over 127 or over 7, and a Gaussian row's absmax is ~3.5 of
    its standard deviations, so a step is ~0.03 (int8) or ~0.5 (int4) of
    them and the error ~1% or ~15% of every weight."""
    w = np.random.default_rng(11).normal(0.0, 0.02, (2048, 512)).astype(np.float32)  # [in, out]
    if mode == "int8":
        q, s = Int8Linear.quantize(_t(w.T))
        got = two.dequantize_kernel(q, s).numpy().T
        want = c8.dequantize_kernel(*c8.quantize_kernel(w))
    else:
        q, s = Int4Linear.quantize(_t(w.T))
        got = two.dequantize_kernel_int4(q, s, w.shape[0]).numpy().T
        want = c8.dequantize_kernel_int4(*c8.quantize_kernel_int4(w), w.shape[0])
    e_port, e_jax = (float(np.linalg.norm(x - w) / np.linalg.norm(w)) for x in (got, want))
    print(f"{mode}: per-channel quantizer rel L2 error on N(0, 0.02) [2048 -> 512], "
          f"port {e_port:.4e}, JAX {e_jax:.4e}")
    assert e_port == pytest.approx(e_jax, rel=1e-6)
    assert (0.005 < e_port < 0.02) if mode == "int8" else (0.1 < e_port < 0.2)
