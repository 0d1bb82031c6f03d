"""`Precision.w8a8_motion`: the SlowFast residual stages' pointwise (1,1,1)
convolutions as int8 x int8 products with both sides quantized on the fly,
against the JAX package's `w8a8_dynamic_matmul` and `SlowFastR50` under
`Precision(w8a8_motion=True)`, on the CPU in fp32.

- `ops/w8a8.w8a8_dynamic_matmul`: the int8 weight and the product equal
  JAX's; the output within 1e-6 relative of JAX's (the same int32 sums,
  one fp32 epilogue);
- the tiny SlowFast under the flag: features within `MOTION_TOL` = 1e-5 of
  the largest JAX feature (a conv input a rounding apart can land on the
  other side of an int8 step; no such flip shows at this seed), while the
  float path is more than 100x that far, so the int8 products ran;
- which convolutions switch: every (1,1,1) conv of the residual stages, no
  stem's, no fusion's; the state_dict and the default are unchanged.
"""

from tests import _torch_threads  # noqa: F401  (before torch does work)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aigv_assessor_torch.core.config import AssessorConfig as TorchConfig
from aigv_assessor_torch.core.precision import Precision as TorchPrecision
from aigv_assessor_torch.models.assessor import AIGVAssessor as TorchAssessor
from aigv_assessor_torch.models.loading import renamed_state
from aigv_assessor_torch.models.motion import ConvBN
from aigv_assessor_torch.models.motion import SlowFastR50 as TorchSlowFast
from aigv_assessor_torch.ops import w8a8 as tw8a8
from aigv_assessor_tpu.core.config import MotionConfig
from aigv_assessor_tpu.core.precision import Precision
from aigv_assessor_tpu.models.motion import SlowFastR50
from aigv_assessor_tpu.ops import w8a8 as jw8a8

MATMUL_TOL = 1e-6
MOTION_TOL = 1e-5
W8A8_FP32 = dataclasses.replace(Precision.fp32(), w8a8_motion=True)


@pytest.mark.parametrize("m,k,n", [(37, 24, 40), (5, 8, 16), (300, 80, 256)])
def test_dynamic_matmul_matches_jax(m, k, n):
    rng = np.random.default_rng(m)
    x = rng.normal(size=(m, k)).astype(np.float32) * 3
    kernel = rng.normal(size=(k, n)).astype(np.float32) * 0.1
    kernel[:, 0] = 0.0  # a dead channel: the 1e-8 floor, not quantize_kernel's 1.0
    want = np.asarray(jw8a8.w8a8_dynamic_matmul(jnp.asarray(x), jnp.asarray(kernel),
                                                out_dtype=jnp.float32))
    calls = []
    real = tw8a8._int_mm

    def counted(xq, wq):
        calls.append(wq)
        return real(xq, wq)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tw8a8, "_int_mm", counted)
        got = tw8a8.w8a8_dynamic_matmul(torch.from_numpy(x), torch.from_numpy(kernel.T.copy()),
                                        out_dtype=torch.float32)
    assert got.dtype == torch.float32 and len(calls) == 1
    kf = kernel.astype(np.float32)
    sw = np.maximum(np.abs(kf).max(axis=0, keepdims=True), 1e-8) / np.float32(127.0)
    wq = np.clip(np.round(kf / sw), -127, 127).astype(np.int8)
    np.testing.assert_array_equal(calls[0].numpy(), wq.T)
    np.testing.assert_allclose(got.numpy(), want, rtol=MATMUL_TOL,
                               atol=MATMUL_TOL * np.abs(want).max())


@pytest.fixture(scope="module")
def slowfast():
    """(JAX params, frames, JAX features under the flag, JAX float features)."""
    cfg = MotionConfig.tiny()
    frames = np.random.default_rng(3).normal(size=(2, 8, 64, 64, 3)).astype(np.float32)
    jmodel = SlowFastR50(cfg, W8A8_FP32)
    params = jax.jit(jmodel.init)(jax.random.key(1), jnp.asarray(frames))
    want = jax.jit(jmodel.apply)(params, jnp.asarray(frames))
    plain = jax.jit(SlowFastR50(cfg, Precision.fp32()).apply)(params, jnp.asarray(frames))
    return jax.device_get(params), frames, np.asarray(want), np.asarray(plain)


def _port(params, w8a8):
    model = TorchSlowFast(TorchConfig.tiny().motion, w8a8=w8a8)
    model.load_state_dict(renamed_state(params), strict=True)
    return model.eval()


def test_slowfast_under_w8a8_motion_matches_jax(slowfast):
    params, frames, want, plain = slowfast
    with torch.no_grad():
        got = _port(params, True)(torch.from_numpy(frames)).numpy()
        float_path = _port(params, False)(torch.from_numpy(frames)).numpy()
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=MOTION_TOL * scale)
    np.testing.assert_allclose(float_path, plain, rtol=0, atol=MOTION_TOL * scale)
    assert np.abs(got - float_path).max() > 100 * MOTION_TOL * scale  # the int8 path ran


def test_only_the_residual_pointwise_convs_switch():
    cfg = TorchConfig.tiny(stage=2)
    model = TorchAssessor(cfg, TorchPrecision(w8a8_motion=True))
    switched = {n for n, m in model.slowfast_model.named_modules()
                if isinstance(m, ConvBN) and m.pointwise_w8a8}
    want = {n for n, m in model.slowfast_model.named_modules()
            if isinstance(m, ConvBN) and "_res" in n and not n.startswith("fuse_")
            and m.conv.kernel_size == (1, 1, 1)}
    assert switched == want and any(n.endswith("shortcut") for n in want)
    assert any(n.endswith("conv_a") for n in want) and any(n.endswith("conv_c") for n in want)
    default = TorchAssessor(cfg, TorchPrecision())
    assert not TorchPrecision().w8a8_motion
    assert not any(getattr(m, "pointwise_w8a8", False) for m in default.modules())
    assert {n: t.shape for n, t in model.state_dict().items()} == {
        n: t.shape for n, t in default.state_dict().items()}
