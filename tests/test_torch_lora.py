"""The port's `LoRALinear` against the JAX package's `LoRADense`.

Weights and inputs come from a numpy seed and go through both layers in
fp32. Outputs and the gradients of the input and of both adapter leaves must
agree to atol = rtol = 1e-5: the same three products in another summation
order. Dropout cannot be matched bit for bit between the frameworks, so the
differential cases run without it and dropout is tested on its own.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aigv_assessor_torch.core.config import LoRAConfig as TorchLoRAConfig
from aigv_assessor_torch.models.lora import (
    LoRALinear,
    is_lora_param,
    lora_free_state_dict,
    make_linear,
    merge_lora_,
    reject_quantized_lora,
    set_generator,
)
from aigv_assessor_tpu.core.config import LoRAConfig
from aigv_assessor_tpu.models.lora import LoRADense, is_lora_param_path

TOL = 1e-5
B, S, HEADS, D, R = 2, 5, 4, 8, 3
C = HEADS * D

# form -> (LoRADense kwargs, LoRALinear kwargs, input shape, out features)
FORMS = {
    "plain": (dict(), dict(), (B, S, C), 24),
    "head_major_out": (dict(head_major=6), dict(heads=6), (B, S, C), 6 * D),
    "head_major_in": (dict(head_major_in=True), dict(head_major_in=True), (B, HEADS, S, D), 24),
}


def _weights(seed, out_features):
    rng = np.random.default_rng(seed)
    return dict(
        kernel=rng.normal(0, 0.2, (C, out_features)).astype(np.float32),
        bias=rng.normal(0, 0.2, (out_features,)).astype(np.float32),
        lora_a=rng.normal(0, 0.3, (C, R)).astype(np.float32),
        lora_b=rng.normal(0, 0.3, (R, out_features)).astype(np.float32),
    )


def _port_layer(w, out_features, dropout=0.0, **kw):
    layer = LoRALinear(C, out_features, lora=TorchLoRAConfig(r=R, alpha=2 * R, dropout=dropout),
                       **kw)
    layer.load_state_dict({
        "weight": torch.from_numpy(w["kernel"].T.copy()), "bias": torch.from_numpy(w["bias"]),
        "lora_a": torch.from_numpy(w["lora_a"]), "lora_b": torch.from_numpy(w["lora_b"]),
    })
    return layer


def test_lora_config_matches_jax():
    import dataclasses

    assert dataclasses.asdict(TorchLoRAConfig()) == dataclasses.asdict(LoRAConfig())
    assert TorchLoRAConfig(r=4, alpha=8).scaling == LoRAConfig(r=4, alpha=8).scaling == 2.0


@pytest.mark.parametrize("form", list(FORMS))
def test_lora_linear_matches_lora_dense(form):
    jax_kw, port_kw, x_shape, out_features = FORMS[form]
    w = _weights(0, out_features)
    rng = np.random.default_rng(1)
    x = rng.normal(size=x_shape).astype(np.float32)

    dense = LoRADense(out_features, use_bias=True, dtype=jnp.float32,
                      lora=LoRAConfig(r=R, alpha=2 * R, dropout=0.0), **jax_kw)
    params = {"params": {"base": {"kernel": w["kernel"], "bias": w["bias"]},
                         "lora_a": w["lora_a"], "lora_b": w["lora_b"]}}
    want = dense.apply(params, jnp.asarray(x))
    cot = rng.normal(size=want.shape).astype(np.float32)  # a fixed cotangent

    def scalar(a, b, xx):
        p = {"params": {"base": params["params"]["base"], "lora_a": a, "lora_b": b}}
        return jnp.sum(dense.apply(p, xx) * cot)

    ga, gb, gx = jax.grad(scalar, argnums=(0, 1, 2))(
        jnp.asarray(w["lora_a"]), jnp.asarray(w["lora_b"]), jnp.asarray(x))

    layer = _port_layer(w, out_features, **port_kw).train()  # dropout 0: train == eval
    xt = torch.from_numpy(x).requires_grad_()
    got = layer(xt)
    assert tuple(got.shape) == want.shape
    (got * torch.from_numpy(cot)).sum().backward()
    for g, wnt in ((got, want), (xt.grad, gx), (layer.lora_a.grad, ga), (layer.lora_b.grad, gb)):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(wnt), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("form", list(FORMS))
def test_merge_lora_keeps_the_output(form):
    """W + (alpha / r) A B computes what base + adapter computed, the
    adapter is inert afterwards, and the merged weights load into a layer
    built without LoRA."""
    _, port_kw, x_shape, out_features = FORMS[form]
    layer = _port_layer(_weights(2, out_features), out_features, **port_kw).eval()
    x = torch.from_numpy(np.random.default_rng(3).normal(size=x_shape).astype(np.float32))
    with torch.no_grad():
        before = layer(x)
        merge_lora_(layer)
        after = layer(x)
        assert not layer.lora_b.any()
        plain = make_linear(C, out_features)  # no adapter: nn.Linear
        plain.load_state_dict(lora_free_state_dict(layer), strict=True)
        flat = x.transpose(1, 2).reshape(B, S, C) if form == "head_major_in" else x
        served = plain(flat)
        if form == "head_major_out":
            served = served.view(B, S, port_kw["heads"], -1).transpose(1, 2)
    torch.testing.assert_close(after, before, rtol=TOL, atol=TOL)
    torch.testing.assert_close(served, before, rtol=TOL, atol=TOL)


def test_dropout_is_reproducible_and_off_in_eval():
    """Dropout acts on the adapter's input only, in training only, and draws
    from the generator that `set_generator` hands in."""
    w = _weights(4, 24)
    layer = _port_layer(w, 24, dropout=0.5)
    x = torch.from_numpy(np.random.default_rng(5).normal(size=(B, S, C)).astype(np.float32))
    with pytest.raises(RuntimeError, match="generator"):
        layer.train()(x)
    gen = torch.Generator().manual_seed(7)
    set_generator(layer, gen)
    with torch.no_grad():
        first = layer(x)
        second = layer(x)
        gen.manual_seed(7)
        again = layer(x)
        quiet = layer.eval()(x)
        base = torch.nn.functional.linear(x, layer.weight, layer.bias)
    assert not torch.equal(first, second)  # the generator moved on
    torch.testing.assert_close(again, first, rtol=0, atol=0)
    want = base + (x @ layer.lora_a) @ layer.lora_b * 2.0
    torch.testing.assert_close(quiet, want, rtol=TOL, atol=TOL)
    # with lora_b = 0 the masks cannot reach the output: the base is not dropped
    layer.lora_b.data.zero_()
    with torch.no_grad():
        torch.testing.assert_close(layer.train()(x), base, rtol=0, atol=0)


def test_fp32_masters_beside_a_bf16_base():
    """The adapters stay fp32 while the base and the activations are bf16;
    their gradients arrive in fp32."""
    layer = _port_layer(_weights(6, 24), 24)
    layer.weight.data = layer.weight.data.to(torch.bfloat16)
    layer.bias.data = layer.bias.data.to(torch.bfloat16)
    layer.weight.requires_grad_(False)
    layer.bias.requires_grad_(False)
    x = torch.randn((B, S, C), generator=torch.Generator().manual_seed(0)).to(torch.bfloat16)
    y = layer(x)
    assert y.dtype == torch.bfloat16
    y.float().sum().backward()
    assert layer.lora_a.grad.dtype == layer.lora_b.grad.dtype == torch.float32
    assert layer.weight.grad is None


@pytest.mark.parametrize("name,want", [
    ("vision_model.layers.0.attn.qkv.lora_a", True),
    ("language_model/layers/attention/wo/lora_b", True),
    ("vision_model.layers.0.attn.qkv.weight", False),
    ("mlpscore.fc1.bias", False),
])
def test_is_lora_param(name, want):
    assert is_lora_param(name) is want
    assert is_lora_param_path(tuple(name.replace(".", "/").split("/"))) is want


def test_make_linear_without_an_adapter_is_a_plain_linear():
    assert type(make_linear(8, 4)) is torch.nn.Linear
    assert type(make_linear(8, 4, lora=TorchLoRAConfig(r=0))) is torch.nn.Linear
    with pytest.raises(ValueError, match="exclude"):
        LoRALinear(8, 4, lora=TorchLoRAConfig(), heads=2, head_major_in=True)


def test_lora_over_a_w8a8_base_is_not_ported():
    from aigv_assessor_torch.core.precision import Precision

    reject_quantized_lora(Precision(w8a8=True), None)
    reject_quantized_lora(Precision(), TorchLoRAConfig())
    with pytest.raises(NotImplementedError, match="W8A8"):
        reject_quantized_lora(Precision(w8a8=True), TorchLoRAConfig())
