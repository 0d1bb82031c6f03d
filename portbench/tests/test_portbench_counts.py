"""The yardstick's arithmetic at hand-checked shapes."""

import json

import pytest

from conftest import ROOT
from portbench import counts


def config(name):
    return json.loads((ROOT / "portbench" / "configs" / f"{name}.json").read_text())["config"]


def test_pairs():
    assert counts.causal_pairs(1) == 1
    assert counts.causal_pairs(4) == 10  # 1 + 2 + 3 + 4
    assert counts.causal_pairs(2113) == 2113 * 2114 // 2
    assert counts.full_pairs(1025, 1025) == 1025 ** 2


def test_shapes_of_the_2b_prompt():
    cfg = config("internvl2_2b")
    assert counts.vit_tokens(cfg) == 1025  # 32 x 32 patches and the class token
    assert counts.image_tokens(cfg) == 256
    assert counts.prompt_len(cfg, 8, 64) == 2113


@pytest.mark.parametrize("name, total, parts", [
    ("internvl2_2b", 12.66e12, {"vit": 4.96e12, "vit_attention": 0.826e12,
                                "decoder": 6.38e12, "decoder_attention": 0.439e12}),
    ("internvl2_26b", 177.8e12, {"vit": 90.7e12, "vit_attention": 4.84e12,
                                 "decoder": 79.1e12, "decoder_attention": 2.63e12,
                                 "mlp1": 0.477e12}),
])
def test_flops_of_one_video(name, total, parts):
    f = counts.video_flops(config(name), 8, 64)
    assert f["total"] == pytest.approx(total, rel=2e-3)
    for key, value in parts.items():
        assert f[key] == pytest.approx(value, rel=3e-3), key
    assert f["total"] == pytest.approx(sum(v for k, v in f.items() if k != "total"))


def test_2b_decoder_by_hand():
    # per layer: wqkv 2048 x (16 + 2 * 8) * 128, wo 2048 x 2048, w1 / w3 / w2 2048 x 8192
    per_layer = 2048 * 4096 + 2048 * 2048 + 3 * 2048 * 8192
    f = counts.video_flops(config("internvl2_2b"), 8, 64)
    assert f["decoder"] == 2.0 * 2113 * per_layer * 24
    # attention: two products of 2 * pairs * 128 over 16 heads and 24 layers
    assert f["decoder_attention"] == 4.0 * (2113 * 2114 // 2) * 16 * 24 * 128
    # the ViT's over its 1025 real tokens, 16 heads of 64, 24 layers, 8 frames
    assert f["vit_attention"] == 4.0 * 1025 ** 2 * 16 * 24 * 8 * 64


def test_attention_bytes_and_backward():
    work = counts.attention_work(config("internvl2_2b"), 8, 64)
    # q, k, v, out of 1025 x 1024 in bf16 and the lse of 16 heads in fp32, a layer a frame
    assert work["vit"]["bytes"] == (4 * 1025 * 1024 * 2 + 1025 * 16 * 4) * 24 * 8
    # q and out of 16 heads, k and v of 8, 128 wide, bf16; lse of 16 heads
    assert work["llm"]["bytes"] == (2113 * (2 * 16 + 2 * 8) * 128 * 2 + 2113 * 16 * 4) * 24
    for w in work.values():
        assert w["bwd_flops"] == pytest.approx(2.5 * w["flops"])


def test_roofline_is_the_larger_bound():
    assert counts.roofline_s(989e12, 0) == pytest.approx(1.0)
    assert counts.roofline_s(0, 3.35e12) == pytest.approx(1.0)
    assert counts.roofline_s(989e12, 2 * 3.35e12) == pytest.approx(2.0)
