"""The ViT's position-embedding interpolation, `select_layer` and selective
remat policies, on the CPU.

- `ops/resize.bicubic_resize_grid` against the JAX package's
  (`aigv_assessor_tpu/ops/resize.py`, constant matrices of torch's bicubic
  weights) on grids up, down and across, to RESIZE_TOL (the same taps
  summed in another order in fp32).
- The tiny ViT, one JAX fp32 tree mapped into the port, at a non-native
  patch grid (the grid part of the position embedding resized), and at
  `select_layer` -2 and 1 (the hidden state that many layers deep): its
  output against JAX's to TOL, and the whole stage-2 forward at a
  `force_image_size` other than the tower's.
- The remat policies (`ops/remat.py`) on the tiny ViT with adapters, adapter
  dropout and drop path in training: the adapters' gradients under every
  policy name bit-equal to whole-layer recompute (the same operations on
  the same inputs); under `dots_with_no_batch_dims_saveable` the backward
  runs fewer `mm` / `addmm` than whole-layer recompute (the forward's are
  kept) but as many batched products, so the attention, a custom autograd
  Function whose CPU version is einsums, is recomputed; `dots_saveable`
  keeps those too; an unknown name raises at the build, and not without
  `grad_checkpoint`, as in JAX; `--vit_remat_policy` reaches the tower from
  the training CLI.
"""

from tests import _torch_threads  # noqa: F401  (before torch does work)
import collections
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from aigv_assessor_torch.core.config import AssessorConfig as TorchConfig
from aigv_assessor_torch.core.config import LoRAConfig as TorchLoRAConfig
from aigv_assessor_torch.core.precision import Precision as TorchPrecision
from aigv_assessor_torch.models.assessor import AIGVAssessor as TorchAssessor
from aigv_assessor_torch.models.loading import init_lora_, init_random_, state_dict_from_jax
from aigv_assessor_torch.models.lora import is_lora_param, set_generator
from aigv_assessor_torch.models.vit import InternVisionModel
from aigv_assessor_torch.ops import flash_attention
from aigv_assessor_torch.ops.remat import POLICIES, policy_fn
from aigv_assessor_torch.ops.resize import bicubic_resize_grid
from aigv_assessor_tpu.core.config import AssessorConfig
from aigv_assessor_tpu.core.precision import Precision
from aigv_assessor_tpu.models.assessor import AIGVAssessor
from aigv_assessor_tpu.ops.resize import bicubic_resize_grid as jax_bicubic_resize_grid

RESIZE_TOL = 1e-5
TOL = 2e-4  # the fp32 slice (tests/test_torch_models.py)
CTX = 7
T = 2
TEXT = 10


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))  # a writable copy


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("src,dst", [((4, 4), (6, 6)), ((6, 6), (4, 4)), ((4, 5), (7, 3)),
                                     ((32, 32), (24, 24))])
def test_bicubic_resize_grid_matches_jax(src, dst):
    grid = np.random.default_rng(0).normal(size=(2, *src, 8)).astype(np.float32)
    want = jax_bicubic_resize_grid(jnp.asarray(grid), *dst)
    got = bicubic_resize_grid(_t(grid), *dst)
    assert tuple(got.shape) == want.shape and got.dtype == torch.float32
    _close(got, want, RESIZE_TOL)
    half = _t(grid).to(torch.bfloat16)
    bf16 = bicubic_resize_grid(half, *dst)
    assert bf16.dtype == torch.bfloat16  # fp32 inside, then cast
    assert torch.equal(bf16, bicubic_resize_grid(half.float(), *dst).to(torch.bfloat16))


@pytest.fixture(scope="module")
def vit_pair():
    """(JAX model, its fp32 params, the port model, JAX config, port
    config): stage 2, the tiny config, no adapters."""
    cfg = AssessorConfig.tiny(stage=2).replace(img_context_token_id=CTX)
    model = AIGVAssessor(cfg, Precision.fp32())
    n = T * cfg.num_image_token + 1 + TEXT
    ids = jnp.asarray(np.random.default_rng(0).integers(10, 500, (1, n)), jnp.int32)
    px = jnp.zeros((1, T, 56, 56, 3), jnp.float32)
    params = jax.device_get(jax.jit(model.init)(jax.random.key(0), ids, px))
    params = jax.tree_util.tree_map_with_path(  # open the score head's ReLUs
        lambda p, x: np.abs(x) if "mlpscore" in str(p) and str(p[-1].key) == "kernel" else x,
        params)
    tcfg = TorchConfig.tiny(stage=2).replace(img_context_token_id=CTX)
    port = TorchAssessor(tcfg, TorchPrecision.fp32())
    port.load_state_dict(state_dict_from_jax(params, tcfg), strict=True)
    return model, params, port.eval(), cfg, tcfg


@pytest.mark.parametrize("size,select_layer", [(84, -1), (42, -1), (56, -2), (56, 1),
                                               (84, -2)])
def test_vit_at_other_grids_and_depths_matches_jax(vit_pair, size, select_layer):
    """A 6 x 6 or 3 x 3 patch grid against the 4 x 4 position embedding, and
    the hidden state `select_layer` deep, of the tiny ViT."""
    model, params, port, _, _ = vit_pair
    frames = np.random.default_rng(size - select_layer).normal(
        size=(T, size, size, 3)).astype(np.float32)
    want = model.apply(params, jnp.asarray(frames),
                       method=lambda m, x: m.vision_model(x, select_layer=select_layer))
    with torch.no_grad():
        got = port.vision_model(_t(frames), select_layer=select_layer)
    assert tuple(got.shape) == want.shape == (T, 1 + (size // 14) ** 2, 32)
    _close(got, want)
    if select_layer != -1:  # not the last layer's state
        with torch.no_grad():
            last = port.vision_model(_t(frames))
        assert (last - got).abs().max() > 1e-2


def test_forward_at_another_image_size_matches_jax(vit_pair):
    """The stage-2 forward at force_image_size 84 (6 x 6 patches, 9 image
    tokens a frame) and select_layer -2, through `extract_feature`."""
    model, params, port, cfg, tcfg = vit_pair
    cfg = cfg.replace(force_image_size=84, select_layer=-2)
    tcfg = tcfg.replace(force_image_size=84, select_layer=-2)
    assert cfg.num_image_token == tcfg.num_image_token == 9
    rng = np.random.default_rng(3)
    n_ctx = T * cfg.num_image_token + 1
    ids = rng.integers(10, 500, (2, n_ctx + TEXT)).astype(np.int32)
    ids[:, 1 : 1 + n_ctx] = CTX
    mask = np.ones(ids.shape, bool)
    px = rng.normal(size=(2, T, 84, 84, 3)).astype(np.float32)
    want = AIGVAssessor(cfg, Precision.fp32()).apply(
        params, jnp.asarray(ids), jnp.asarray(px), jnp.asarray(mask), with_logits=False)
    other = TorchAssessor(tcfg, TorchPrecision.fp32()).eval()
    other.load_state_dict(port.state_dict(), strict=True)
    with torch.no_grad():
        got = other(_t(ids).long(), _t(px), _t(mask))
    _close(got["hidden"], want["hidden"])
    _close(got["score"], want["score"])
    assert float(np.abs(np.asarray(want["score"])).max()) > 0


# ------------------------------------------------------------ remat ---


class _Executed(TorchDispatchMode):
    """Counts the ATen ops that run (an op SAC hands back from its cache
    never reaches this mode)."""

    def __init__(self):
        super().__init__()
        self.ops = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops[func] += 1
        return func(*args, **(kwargs or {}))


def _vit_grads(policy, grad_checkpoint=True):
    """The adapters' gradients of (ViT output . u) in training, adapter
    dropout 0.05 and drop path 0.1 from one seeded generator -> (grads,
    products run in the backward, attention forwards run)."""
    vision = dataclasses.replace(TorchConfig.tiny().vision, drop_path_rate=0.1)
    vit = InternVisionModel(vision, TorchPrecision.fp32(),
                            lora=TorchLoRAConfig(r=2, alpha=4, dropout=0.05),
                            grad_checkpoint=grad_checkpoint, remat_policy=policy)
    init_lora_(init_random_(vit, 0), 2)
    with torch.no_grad():
        for name, p in vit.named_parameters():
            p.requires_grad_(is_lora_param(name))  # the frozen base of stage 2
            if name.endswith("lora_b"):
                p.normal_(0.0, 0.05, generator=torch.Generator().manual_seed(len(name)))
    vit.train()
    set_generator(vit, torch.Generator().manual_seed(11))
    rng = np.random.default_rng(4)
    frames = _t(rng.normal(size=(T, 56, 56, 3)).astype(np.float32))
    u = _t(rng.normal(size=(T, 17, 32)).astype(np.float32))
    calls = [0]
    real = flash_attention.flash_attention_qkv_lse

    def spy(*a, **kw):
        calls[0] += 1
        return real(*a, **kw)

    flash_attention.flash_attention_qkv_lse = spy
    try:
        loss = (vit(frames) * u).sum()
        with _Executed() as seen:
            loss.backward()
    finally:
        flash_attention.flash_attention_qkv_lse = real
    grads = {n: p.grad for n, p in vit.named_parameters() if p.grad is not None}
    aten = torch.ops.aten
    return grads, dict(
        unbatched=seen.ops[aten.mm.default] + seen.ops[aten.addmm.default],
        batched=seen.ops[aten.bmm.default], attention=calls[0])


@pytest.fixture(scope="module")
def full_remat():
    return _vit_grads(None)


@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_remat_policies_give_full_remats_gradients(full_remat, policy):
    want, full = full_remat
    got, ran = _vit_grads(policy)
    assert set(got) == set(want) and len(want) == 2 * 2 * 4  # lora_a, lora_b x 4 x 2 layers
    for name in want:
        assert torch.equal(got[name], want[name]), name
    assert ran["attention"] == full["attention"] == 2 * 2  # pass and recompute, 2 layers
    if policy in ("dots_with_no_batch_dims_saveable", "checkpoint_dots_with_no_batch_dims"):
        assert ran["unbatched"] < full["unbatched"]
        assert ran["batched"] == full["batched"]  # the attention recomputed
    elif policy in ("dots_saveable", "checkpoint_dots"):
        assert ran["unbatched"] < full["unbatched"] and ran["batched"] < full["batched"]
    elif policy == "everything_saveable":
        assert ran["unbatched"] < full["unbatched"] and ran["batched"] < full["batched"]
    else:
        assert ran == full


def test_no_checkpointing_gives_the_same_gradients(full_remat):
    want, _ = full_remat
    got, _ = _vit_grads("dots_saveable", grad_checkpoint=False)
    for name in want:
        assert torch.equal(got[name], want[name]), name


def test_unknown_policy_raises_at_the_build():
    cfg = TorchConfig.tiny(stage=2)
    with pytest.raises(ValueError, match="unknown remat policy"):
        InternVisionModel(cfg.vision, grad_checkpoint=True, remat_policy="dots_saveabel")
    with pytest.raises(ValueError, match="unknown remat policy"):
        policy_fn("save_everything")
    # unused without checkpointing, as the JAX model reads it only under remat
    assert InternVisionModel(cfg.vision, remat_policy="dots_saveabel").remat_policy is None


def test_cli_flag_reaches_the_tower(monkeypatch, tmp_path):
    """`--vit_remat_policy` through `cli/stage2_train.main` into
    `build_training_model` and the tower; dropped with `--grad_checkpoint
    False`."""
    from aigv_assessor_torch.cli import stage1_train, stage2_train

    built = []

    class Stop(Exception):
        pass

    def build(config, **kw):
        built.append(TorchAssessor(config, TorchPrecision.fp32(),
                                   grad_checkpoint=kw["grad_checkpoint"],
                                   vit_remat_policy=kw["vit_remat_policy"]))
        raise Stop

    monkeypatch.setattr(stage1_train, "build_datasets", lambda *a, **kw: [None] * 8)
    monkeypatch.setattr(stage2_train, "build_training_model", build)
    base = ["--meta_path", "unused", "--model_scale", "tiny", "--device", "cpu", "--bf16",
            "False", "--output_dir", str(tmp_path), "--use_backbone_lora", "2",
            "--vit_remat_policy", "dots_with_no_batch_dims_saveable"]
    for extra in ([], ["--grad_checkpoint", "False"]):
        with pytest.raises(Stop):
            stage2_train.main(base + extra)
    assert built[0].vision_model.remat_policy == "dots_with_no_batch_dims_saveable"
    assert built[1].vision_model.remat_policy is None
