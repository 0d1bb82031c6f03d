"""The port's reader and writer of flax's msgpack format
(`aigv_assessor_torch/utils/flax_msgpack.py`) against
`flax.serialization`, on the CPU.

- the reader on `msgpack_serialize` output: fp32, bf16, int8 and int32
  arrays, 0-d int32 arrays, numpy scalars, Python scalars, None and nested
  maps, every array value bit for bit, bf16 read as `torch.bfloat16`;
- the writer's bytes equal to flax's for the same tree (keys sorted, as
  flax's copy of the tree sorts them), and a read-then-write round trip
  byte for byte;
- a chunked leaf, with `MAX_CHUNK_SIZE` patched small in both packages:
  flax's chunk records read back whole, the writer's chunks equal to flax's;
- a JAX parameter tree from `model.init`, and the refusal of a missing
  `msgpack` package.
"""

from tests import _torch_threads  # noqa: F401  (before torch does work)
import builtins

import flax.serialization as fser
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aigv_assessor_torch.utils import flax_msgpack as fm


def _bf16(x: np.ndarray) -> np.ndarray:
    return np.asarray(jnp.asarray(x, jnp.bfloat16))


def _to_torch(tree):
    """The port's form of a flax tree: arrays as tensors, scalars kept."""
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    if isinstance(tree, np.ndarray):
        if tree.dtype.name == "bfloat16":
            return torch.from_numpy(tree.view(np.uint16).copy()).view(torch.bfloat16)
        return torch.from_numpy(tree.copy())
    return tree


def _assert_same(got, want):
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == sorted(want), (list(got), list(want))
        for k in want:
            _assert_same(got[k], want[k])
    elif isinstance(want, np.ndarray):
        assert isinstance(got, torch.Tensor)
        assert tuple(got.shape) == want.shape
        if want.dtype.name == "bfloat16":
            assert got.dtype == torch.bfloat16
            np.testing.assert_array_equal(got.view(torch.int16).numpy(), want.view(np.int16))
        else:
            assert got.numpy().dtype == want.dtype
            np.testing.assert_array_equal(got.numpy(), want)
    elif isinstance(want, np.generic):
        assert type(got) is type(want) and got == want
    else:
        assert got == want and type(got) is type(want)


def _tree(rng):
    return {
        "params": {
            "b_tower": {"kernel": rng.normal(size=(4, 6)).astype(np.float32),
                        "bias": np.zeros(6, np.float32)},
            "a_tower": {
                "embedding": _bf16(rng.normal(size=(3, 5))),
                "kernel_int8": rng.integers(-127, 128, (7, 3)).astype(np.int8),
                "kernel_in_dim": np.asarray(7, np.int32),
                "ids": rng.integers(0, 1000, (2, 3)).astype(np.int32),
            },
            "empty_1d": np.zeros((0,), np.float32),
        },
        "step": np.int64(3),
        "lr": np.float32(0.5),
        "epoch": 2,
        "decay": 0.25,
        "done": True,
        "note": None,
    }


def test_reader_equals_flax_restore():
    tree = _tree(np.random.default_rng(0))
    _assert_same(fm.restore(fser.msgpack_serialize(tree)), tree)


def test_writer_bytes_equal_flax_and_round_trip():
    tree = _tree(np.random.default_rng(1))
    want = fser.msgpack_serialize(tree)
    assert fm.serialize(_to_torch(tree)) == want
    assert fm.serialize(fm.restore(want)) == want
    # numpy arrays are taken too
    assert fm.serialize(tree) == want


def test_chunked_leaf(monkeypatch):
    monkeypatch.setattr(fser, "MAX_CHUNK_SIZE", 64)
    monkeypatch.setattr(fm, "MAX_CHUNK_SIZE", 64)
    rng = np.random.default_rng(2)
    tree = {"params": {"big": rng.normal(size=(10, 7)).astype(np.float32),
                       "big_bf16": _bf16(rng.normal(size=(9, 11))),
                       "big_int8": rng.integers(-127, 128, (5, 33)).astype(np.int8),
                       "small": np.ones(3, np.float32)}}
    data = fser.msgpack_serialize(tree)
    raw = fser.msgpack.unpackb(data, raw=False, ext_hook=lambda c, d: None)
    assert raw["params"]["big"][fm.CHUNKED] is True  # flax did chunk it
    _assert_same(fm.restore(data), tree)
    assert fm.serialize(_to_torch(tree)) == data


def test_jax_param_tree_round_trip(tmp_path):
    from aigv_assessor_tpu.core.config import AssessorConfig
    from aigv_assessor_tpu.core.precision import Precision
    from aigv_assessor_tpu.models.assessor import AIGVAssessor

    cfg = AssessorConfig.tiny(stage=2).replace(img_context_token_id=4)
    params = jax.device_get(jax.jit(AIGVAssessor(cfg, Precision.fp32()).init)(
        jax.random.key(0), jnp.zeros((1, 32), jnp.int32), jnp.zeros((1, 4, 56, 56, 3))))
    path = tmp_path / "params.msgpack"
    path.write_bytes(fser.msgpack_serialize(params))
    tree = fm.load(str(path))
    _assert_same(tree, jax.tree_util.tree_map(np.asarray, params))
    out = tmp_path / "again.msgpack"
    fm.save(str(out), tree)
    assert out.read_bytes() == path.read_bytes()


def test_missing_msgpack_raises(monkeypatch, tmp_path):
    real_import = builtins.__import__

    def no_msgpack(name, *args, **kw):
        if name == "msgpack":
            raise ImportError("No module named 'msgpack'")
        return real_import(name, *args, **kw)

    monkeypatch.setattr(builtins, "__import__", no_msgpack)
    path = tmp_path / "params.msgpack"
    with pytest.raises(ImportError, match="params.msgpack"):
        fm.load(str(path))
    with pytest.raises(ImportError, match="msgpack"):
        fm.serialize({"a": np.zeros(2, np.float32)})
