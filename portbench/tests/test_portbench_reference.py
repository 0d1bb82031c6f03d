"""The plain reference against the port at the tiny configurations, in fp32
on the CPU, from the benchmark's seeded weights; and the weights' draw."""

import json

import pytest
import torch

from conftest import ROOT
from portbench import check, inputs
from portbench.reference import model as ref
from portbench.weights import SeededWeights, param_spec

SEED = 2**40 + 12345


def tiny(name):
    return json.loads((ROOT / "portbench" / "tests" / f"{name}.json").read_text())["config"]


def test_groups_redraw_bit_for_bit_and_seeds_differ():
    cfg = tiny("tiny")
    a = SeededWeights(cfg, SEED, "cpu", torch.float32)
    b = SeededWeights(cfg, SEED, "cpu", torch.float32)
    c = SeededWeights(cfg, SEED + 1, "cpu", torch.float32)
    for group in ("vision_model.layers.0", "mlpscore", "slowfast_model"):
        ga = {k: v.clone() for k, v in a.group(group).items()}
        a.group("mlp1")  # another group in between
        for k, v in a.group(group).items():
            assert torch.equal(v, ga[k])
            assert torch.equal(v, b[k])
            assert not torch.equal(v, c[k])
    last = [leaf for g, leaves in param_spec(cfg) if g == "mlpscore" for leaf in leaves][-2]
    assert bool((a[last[0]] >= 0).all())  # the head's last weights are non-negative


@pytest.mark.parametrize("name", ["tiny", "tiny_qknorm"])
def test_reference_matches_the_port(name):
    from aigv_assessor_torch.cli.common import build_serving_model
    from aigv_assessor_torch.cli.score import score_batch
    from aigv_assessor_torch.core.config import AssessorConfig
    from aigv_assessor_torch.core.precision import Precision

    torch.set_num_threads(2)
    cfg = tiny(name)
    weights = SeededWeights(cfg, SEED, "cpu", torch.float32)
    model = build_serving_model(AssessorConfig.from_dict(cfg), device="cpu",
                                precision=Precision.fp32(), weights=weights)
    state = model.state_dict()
    assert set(state) == set(weights)
    for k in weights:
        assert tuple(state[k].shape) == tuple(weights[k].shape), k
        assert torch.equal(state[k], weights[k]), k

    traffic = {"frames": 8, "text_tokens": 16, "pool": 3}
    ids = inputs.prompt_ids(cfg, traffic, SEED)
    pixels = torch.as_tensor(inputs.video_pool(cfg, traffic, SEED, "cpu"))
    kept = {}
    model.mlp1.register_forward_hook(lambda m, a, o: kept.__setitem__("features", o))
    model.motion_mlp.register_forward_hook(lambda m, a, o: kept.__setitem__("motion", o))
    model.mlpscore.register_forward_pre_hook(lambda m, a: kept.__setitem__("readout", a[0]))
    ids_t = torch.as_tensor(ids)
    with torch.no_grad():
        scores = score_batch(model, ids_t[None, None].expand(3, 1, -1), pixels,
                             torch.ones(3, 1, len(ids), dtype=torch.bool))
    program = {"features": kept["features"].reshape(3, -1, kept["features"].shape[-1]),
               "motion": kept["motion"], "readout": kept["readout"].reshape(3, -1),
               "score": scores[:, 0]}
    data = {"ids": ids, "pixels": pixels, "program": program}
    numbers = check.gaps(program, check.reference_outputs(cfg, weights, data, "cpu"))
    assert set(numbers) == {"features_gap", "motion_gap", "readout_gap", "score_gap",
                            "score_head_gap"}
    for key, value in numbers.items():
        assert value < 1e-5, (key, value)
    # the reference scores something: the scores differ between the videos
    assert float(program["score"].std()) > 0


def test_fp8_rounding_is_a_lower_precision():
    x = torch.randn(64, 256, generator=torch.Generator().manual_seed(0))
    err = (ref.fp8_round(x) - x).norm() / x.norm()
    bf16 = (x.bfloat16().float() - x).norm() / x.norm()
    assert 4 * bf16 < err < 0.1
