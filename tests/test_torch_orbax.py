"""The trainer's checkpoints in JAX's orbax layout, read and written by the
port without orbax or tensorstore, against the JAX package's
`CheckpointManager` (orbax 0.11 over tensorstore) on the CPU:

- `utils/zstd` round trips, frames without a recorded size, and the error
  that names libzstd when it cannot be loaded (the reader then raises too);
- `utils/ocdbt` against tensorstore: stores that tensorstore writes (orbax's
  configuration, compression off, B+-trees of several levels) read key for
  key, and stores the port writes read by tensorstore;
- the committed JAX-written fixture (`tests/_orbax_fixture.py`): the script
  still reproduces the recorded hashes, and the port reads every leaf to
  them;
- JAX-written -> port: the tiny stage-1 state after one JAX step, every leaf
  bit-equal to `jax.device_get(state)` and loaded into the port's trainer
  (the frozen towers too), then one more step against JAX's
  restored-and-stepped trainer in fp32: loss to 1e-5 relative, parameters
  to 1e-5;
- port-written -> JAX: `CheckpointManager.restore(template)` and
  `restore_best` give the leaves bit for bit, orbax passes over the port's
  extras file, and JAX's next step equals the port's;
- the best slot and retention both ways, a leaf split into several chunks
  both ways (JAX's from a leaf sharded over two devices, the port's from a
  small chunk target), the port's chunk shapes against orbax's
  `choose_chunk_shape`, and the layer-decay chain with bf16 frozen towers.

The JAX side runs once per module: one initialization, one compiled step
reused for every further step.
"""

from tests import _torch_threads  # noqa: F401  (before torch does work)
import dataclasses
import hashlib
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import tensorstore as ts
import torch

from aigv_assessor_torch.core.config import AssessorConfig as TorchConfig
from aigv_assessor_torch.core.precision import Precision as TorchPrecision
from aigv_assessor_torch.models.assessor import AIGVAssessor as TorchAssessor
from aigv_assessor_torch.models.loading import init_random_, state_dict_from_jax
from aigv_assessor_torch.train import trainer as ttrainer
from aigv_assessor_torch.train.checkpoint import EXTRAS_FILE, CheckpointManager
from aigv_assessor_torch.utils import ocdbt, orbax_format, zstd
from aigv_assessor_tpu.core.mesh import MeshConfig, make_mesh
from aigv_assessor_tpu.core.precision import Precision
from aigv_assessor_tpu.models.assessor import AIGVAssessor
from aigv_assessor_tpu.train import trainer as jtrainer
from aigv_assessor_tpu.train.checkpoint import CheckpointManager as JaxManager
from tests import _orbax_fixture as fx

PARAM_TOL = 1e-5
LOSS_TOL = 1e-5


def _jax_batch(seed):
    return {k: jnp.asarray(v) for k, v in
            jtrainer.microbatch(fx.batch(fx.config(), 2, seed), 1).items()}


def _port_batch(seed):
    b = {k: torch.from_numpy(v) for k, v in fx.batch(fx.config(), 2, seed).items()}
    b["input_ids"], b["labels"] = b["input_ids"].long(), b["labels"].long()
    return ttrainer.microbatch(b, 1)


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    """The fixture's JAX run (one step, saved at step 1 with the best slot),
    then JAX's restore of it into its trainer and a second step."""
    work = tmp_path_factory.mktemp("orbax")
    run = fx.jax_run(str(work / "jax_ckpt"), best=True, output_dir=str(work / "jax_out"))
    jt = run["trainer"]
    mgr = JaxManager(str(work / "jax_ckpt"))
    restored = mgr.restore(jt.state)
    mgr.close()
    with run["mesh"]:
        jt.state, loss = jt.compiled_step()(restored, _jax_batch(3), jax.random.key(0))
    run.update(work=work, ckpt=work / "jax_ckpt", step2_loss=float(loss),
               step2=jax.device_get(jt.state))
    return run


def _jax_step(run, state):
    """JAX's compiled step from `state` on the second batch -> (loss, host state)."""
    jt = run["trainer"]
    with run["mesh"]:
        new, loss = jt.compiled_step()(state, _jax_batch(3), jax.random.key(0))
    jt.state = new
    return float(loss), jax.device_get(new)


def _port_trainer(tmp, precision=None, seed=1, **kw):
    """A port stage-1 trainer whose weights are drawn from another seed than
    JAX's: a restore must bring every one of them."""
    cfg = TorchConfig.tiny(stage=1).replace(img_context_token_id=fx.CTX)
    model = TorchAssessor(cfg, precision or TorchPrecision.fp32())
    init_random_(model, seed)
    tc = ttrainer.TrainConfig(output_dir=str(tmp), **{**fx.TRAIN, **kw})
    return ttrainer.Trainer(model, tc, fx.TOTAL_STEPS)


def _flat(state):
    return {fx.leaf_name(p): np.asarray(x)
            for p, x in jax.tree_util.tree_flatten_with_path(state)[0]}


def _assert_tree_equal(tree, state):
    """A tree read by the port ({name: tensor}) holds `state`'s leaves bit
    for bit, in their dtypes."""
    want = _flat(state)
    assert set(tree) == set(want)
    for name, x in want.items():
        t = tree[name]
        assert tuple(t.shape) == x.shape, name
        if x.dtype.name == "bfloat16":
            assert t.dtype == torch.bfloat16, name
            assert np.array_equal(t.view(torch.int16).numpy(), x.view(np.int16)), name
        else:
            assert t.numpy().dtype == x.dtype and np.array_equal(t.numpy(), x), name


def _read(item):
    return {orbax_format.leaf_name(k): t for k, t in orbax_format.read_tree(str(item))
            if t is not None}


def _tensor_sha256(t):
    return hashlib.sha256(t.contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()
                          ).hexdigest()


def _assert_port_holds(trainer, state):
    """Every parameter and buffer of the port's trainer, its Adam moments
    and step equal the JAX host `state`, bit for bit."""
    cfg = trainer.model.config
    want = state_dict_from_jax(state.params, cfg)
    got = trainer.model.state_dict()
    for n, t in want.items():
        assert torch.equal(got[n], t.to(got[n].dtype)), n
    mu = _flat(state.opt_state[1][0].mu)
    nu = _flat(state.opt_state[1][0].nu)
    opt = trainer.optimizer
    names = {id(p): n for n, p in trainer.trainable_parameters().items()}
    mu_port = state_dict_from_jax(_nested(mu), cfg, parts=("mlp1", "motion_mlp"))
    nu_port = state_dict_from_jax(_nested(nu), cfg, parts=("mlp1", "motion_mlp"))
    for p, st in opt.state.items():
        n = names[id(p)]
        assert torch.equal(st["exp_avg"], mu_port[n]), n
        assert torch.equal(st["exp_avg_sq"], nu_port[n]), n
        assert float(st["step"]) == int(state.opt_state[1][0].count)
    assert trainer.step == int(state.step)


def _nested(flat):
    """{"params": nested} of a flat {"params.a.b": x} moment tree."""
    out = {}
    for name, x in flat.items():
        node = out
        *parents, leaf = name.split(".")
        for k in parents:
            node = node.setdefault(k, {})
        node[leaf] = x
    return out


# ------------------------------------------------------------------ zstd --

@pytest.mark.parametrize("payload", ["empty", "text", "random", "zeros"])
def test_zstd_round_trip(payload):
    rng = np.random.default_rng(0)
    data = {"empty": b"", "text": b"orbax " * 1000,
            "random": rng.integers(0, 256, 1 << 20, dtype=np.uint8),
            "zeros": np.zeros((64, 1024), np.float32)}[payload]
    frame = zstd.compress(data, 1)
    raw = data.tobytes() if isinstance(data, np.ndarray) else data
    assert frame[:4] == b"\x28\xb5\x2f\xfd" and zstd.frame_content_size(frame) == len(raw)
    assert zstd.decompress(frame).tobytes() == raw
    assert zstd.decompress(np.frombuffer(frame, np.uint8), len(raw)).tobytes() == raw
    with pytest.raises(zstd.ZstdError):
        zstd.decompress(frame, len(raw) + 1)


def test_zstd_reads_frames_without_a_recorded_size(jax_side):
    """tensorstore's chunks and nodes record no content size."""
    item = jax_side["ckpt"] / "1" / "default"
    kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{item}/"}).result()
    frame = kv.read(b"params.params.mlp1.fc1.kernel/0.0").result().value
    assert zstd.frame_content_size(frame) is None
    x = np.asarray(jax_side["state"].params["params"]["mlp1"]["fc1"]["kernel"])
    assert zstd.decompress(frame, x.nbytes).tobytes() == x.tobytes()


def test_without_libzstd_the_reader_raises(monkeypatch):
    def refuse(name, *a, **k):
        raise OSError(f"{name}: cannot open shared object file")

    monkeypatch.setattr(zstd._Lib, "handle", None)
    monkeypatch.setattr(zstd.ctypes, "CDLL", refuse)
    with pytest.raises(zstd.ZstdUnavailable, match="libzstd.so.1"):
        zstd.decompress(b"\x28\xb5\x2f\xfd")
    assert not zstd.available()
    with pytest.raises(zstd.ZstdUnavailable, match="libzstd.so.1"):
        orbax_format.read_tree(os.path.join(fx.CHECKPOINT, "1", "default"))


# ----------------------------------------------------------------- OCDBT --

STORES = {
    "orbax": {"compression": {"id": "zstd", "level": 0}, "max_inline_value_bytes": 1024,
              "max_decoded_node_bytes": 100000000},
    "raw_three_levels": {"compression": None, "max_inline_value_bytes": 8,
                         "max_decoded_node_bytes": 300},
    "zstd_two_levels": {"compression": {"id": "zstd", "level": 3},
                        "max_inline_value_bytes": 16, "max_decoded_node_bytes": 2000},
}


def _values(n=120):
    rng = np.random.default_rng(1)
    return {f"params.leaf{i:03d}.{'kernel' if i % 2 else 'bias'}/{i % 3}.0":
            rng.integers(0, 256, int(rng.integers(0, 60)), dtype=np.uint8).tobytes()
            for i in range(n)}


def _tensorstore_items(path):
    kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{path}/"}).result()
    return {k.decode(): kv.read(k).result().value for k in kv.list().result()}


@pytest.mark.parametrize("config", list(STORES))
def test_ocdbt_reads_what_tensorstore_writes(tmp_path, config):
    values = _values()
    kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{tmp_path}/",
                          "config": STORES[config]}).result()
    with ts.Transaction() as txn:
        for k, v in values.items():
            kv.with_transaction(txn)[k] = v
    store = ocdbt.Store(str(tmp_path))
    if config != "orbax":
        assert store.manifest.height >= 1  # interior nodes
    got = [(k, store.read(v)) for k, v in store.items()]
    assert got == sorted(values.items())


@pytest.mark.parametrize("n", [0, 1, 300])
def test_tensorstore_reads_what_ocdbt_writes(tmp_path, n):
    values = _values(n)
    with ocdbt.Writer(str(tmp_path)) as w:
        for k, v in reversed(values.items()):
            w.put(k, v)
    assert _tensorstore_items(tmp_path) == values
    assert _tensorstore_items(tmp_path / "ocdbt.process_0") == values


def test_ocdbt_checks_the_crc(tmp_path):
    with ocdbt.Writer(str(tmp_path)) as w:
        w.put("a", b"x")
    path = tmp_path / "manifest.ocdbt"
    data = bytearray(path.read_bytes())
    data[20] ^= 1
    path.write_bytes(bytes(data))
    with pytest.raises(ocdbt.OcdbtFormatError, match="CRC"):
        ocdbt.Store(str(tmp_path))


# -------------------------------------------------- the committed fixture --

def test_fixture_script_reproduces_the_recorded_hashes(jax_side):
    with open(fx.HASHES) as f:
        assert fx.leaf_hashes(jax_side["state"]) == json.load(f)


def test_port_reads_the_committed_fixture_to_its_hashes():
    with open(fx.HASHES) as f:
        want = json.load(f)
    tree = _read(os.path.join(fx.CHECKPOINT, "1", "default"))
    assert set(tree) == set(want)
    for name, t in tree.items():
        assert list(t.shape) == want[name]["shape"], name
        assert _tensor_sha256(t) == want[name]["sha256"], name


# ----------------------------------------------------------- JAX -> port --

def test_jax_checkpoint_restores_into_the_port(jax_side, tmp_path):
    _assert_tree_equal(_read(jax_side["ckpt"] / "1" / "default"), jax_side["state"])
    trainer = _port_trainer(tmp_path)
    CheckpointManager(str(jax_side["ckpt"])).restore(trainer)
    _assert_port_holds(trainer, jax_side["state"])
    # JAX wrote no extras: the generator restarts from (seed, step), best_metric from -inf
    want = torch.Generator().manual_seed(trainer.cfg.seed + 1).get_state()
    assert torch.equal(trainer.generator.get_state(), want)
    assert trainer.best_metric == float("-inf")

    loss = float(trainer.train_step(_port_batch(3)))
    assert loss == pytest.approx(jax_side["step2_loss"], rel=LOSS_TOL)
    after = state_dict_from_jax(jax_side["step2"].params, trainer.model.config)
    got = trainer.model.state_dict()
    for n, t in after.items():
        if n in trainer.trainable:
            np.testing.assert_allclose(got[n].numpy(), t.numpy(), rtol=0, atol=PARAM_TOL,
                                       err_msg=n)
        else:  # the frozen towers, as JAX's checkpoint holds them
            assert torch.equal(got[n], t), n


def test_jax_best_slot_restores_into_the_port(jax_side, tmp_path):
    trainer = _port_trainer(tmp_path)
    CheckpointManager(str(jax_side["ckpt"])).restore_best(trainer)
    _assert_port_holds(trainer, jax_side["state"])
    other = _port_trainer(tmp_path)  # the slot named on its own, as --resume_from_checkpoint may
    CheckpointManager(str(jax_side["ckpt"] / "best")).restore(other)
    _assert_port_holds(other, jax_side["state"])


# ----------------------------------------------------------- port -> JAX --

def test_port_checkpoint_restores_in_jax(jax_side, tmp_path):
    trainer = _port_trainer(tmp_path)
    CheckpointManager(str(jax_side["ckpt"])).restore(trainer)
    trainer.best_metric = 0.25
    generator = trainer.generator.get_state()
    mgr = CheckpointManager(str(tmp_path / "port_ckpt"))
    mgr.save(1, trainer, best=True)
    assert (tmp_path / "port_ckpt" / "1" / EXTRAS_FILE).exists()
    assert (tmp_path / "port_ckpt" / "best" / EXTRAS_FILE).exists()

    jm = JaxManager(str(tmp_path / "port_ckpt"))
    assert jm.latest_step() == 1
    template = jax_side["trainer"].state
    restored = jm.restore(template)  # orbax passes over the extras file
    jm.close()
    assert jax.tree_util.tree_structure(restored) == jax.tree_util.tree_structure(template)
    _assert_tree_equal(_read(tmp_path / "port_ckpt" / "1" / "default"), jax_side["state"])
    for name, x in _flat(jax.device_get(restored)).items():
        assert np.array_equal(x, _flat(jax_side["state"])[name]), name
    best = JaxManager(str(tmp_path / "port_ckpt")).restore_best(jax.device_get(template))
    for name, x in _flat(best).items():
        assert np.array_equal(np.asarray(x), _flat(jax_side["state"])[name]), name

    jloss, jstate = _jax_step(jax_side, restored)
    ploss = float(trainer.train_step(_port_batch(3)))
    assert jloss == jax_side["step2_loss"]  # JAX from the port's file = JAX from its own
    assert ploss == pytest.approx(jloss, rel=LOSS_TOL)
    after = state_dict_from_jax(jstate.params, trainer.model.config)
    got = trainer.model.state_dict()
    for n in trainer.trainable:
        np.testing.assert_allclose(got[n].numpy(), after[n].numpy(), rtol=0, atol=PARAM_TOL,
                                   err_msg=n)

    # the port's extras come back with the port
    again = _port_trainer(tmp_path)
    mgr.restore(again)
    assert again.best_metric == 0.25
    assert torch.equal(again.generator.get_state(), generator)


# ------------------------------------------------ best slot and retention --

def test_port_best_slot_and_retention_read_by_jax(jax_side, tmp_path):
    trainer = _port_trainer(tmp_path)
    CheckpointManager(str(jax_side["ckpt"])).restore(trainer)
    mgr = CheckpointManager(str(tmp_path / "ck"), save_total_limit=2)
    for step in (1, 2, 3):
        trainer.step = step
        mgr.save(step, trainer, best=step == 2)
    trainer.step = 9
    mgr.save(2, trainer)  # not newer than the newest: skipped, as orbax skips it
    assert sorted(os.listdir(tmp_path / "ck")) == ["2", "3", "best"]
    assert mgr.latest_step() == 3
    jm = JaxManager(str(tmp_path / "ck"))
    assert jm._mgr.all_steps() == [2, 3] and jm.latest_step() == 3
    host = jax.device_get(jax_side["trainer"].state)
    assert int(jm.restore(host, step=2).step) == 2
    assert int(jm.restore_best(host).step) == 2
    jm.close()
    mgr.restore(trainer)
    assert trainer.step == 3
    mgr.restore_best(trainer)
    assert trainer.step == 2


def test_jax_best_slot_and_retention_read_by_the_port(jax_side, tmp_path):
    jm = JaxManager(str(tmp_path / "ck"), save_total_limit=2)
    state = jax_side["state"]
    for step in (1, 2, 3):
        jm.save(step, dataclasses.replace(state, step=np.int32(step)), best=step == 2)
    jm.close()
    mgr = CheckpointManager(str(tmp_path / "ck"))
    assert mgr._steps() == [2, 3] and mgr.latest_step() == 3
    trainer = _port_trainer(tmp_path)
    mgr.restore(trainer)
    assert trainer.step == 3
    mgr.restore(trainer, step=2)
    assert trainer.step == 2
    CheckpointManager(str(tmp_path / "ck" / "3")).restore(trainer)
    assert trainer.step == 3
    mgr.restore_best(trainer)
    assert trainer.step == 2


# --------------------------------------------------------------- chunks --

def test_jax_leaves_sharded_over_two_devices_read_in_chunks(jax_side, tmp_path):
    mesh = make_mesh(MeshConfig(data=1, fsdp=2))
    jt = jtrainer.Trainer(jax_side["model"], jax_side["params"],
                          jtrainer.TrainConfig(grad_checkpoint=False, output_dir=str(tmp_path),
                                               **fx.TRAIN), fx.TOTAL_STEPS, mesh=mesh)
    jm = JaxManager(str(tmp_path / "ck"))
    jm.save(0, jt.state)
    jm.close()
    item = tmp_path / "ck" / "0" / "default"
    with open(item / "array_metadatas" / "process_0") as f:
        meta = json.load(f)["array_metadatas"]
    tree = _read(item)
    split = [m["array_metadata"]["param_name"] for m in meta
             if m["array_metadata"]["chunk_shape"] != list(tree[m["array_metadata"]["param_name"]].shape)]
    assert len(split) > 10  # leaves orbax wrote as several chunks
    _assert_tree_equal(tree, jax.device_get(jt.state))
    trainer = _port_trainer(tmp_path)
    CheckpointManager(str(tmp_path / "ck")).restore(trainer)
    _assert_port_holds(trainer, jax.device_get(jt.state))


def test_port_leaves_in_chunks_read_by_jax(jax_side, tmp_path, monkeypatch):
    trainer = _port_trainer(tmp_path)
    CheckpointManager(str(jax_side["ckpt"])).restore(trainer)
    monkeypatch.setattr(orbax_format, "TARGET_CHUNK_BYTES", 4096)
    CheckpointManager(str(tmp_path / "ck")).save(1, trainer)
    with open(tmp_path / "ck" / "1" / "default" / "array_metadatas" / "process_0") as f:
        meta = json.load(f)["array_metadatas"]
    assert sum(m["array_metadata"]["chunk_shape"] != m["array_metadata"]["write_shape"]
               for m in meta) > 10
    host = jax.device_get(jax_side["trainer"].state)
    restored = JaxManager(str(tmp_path / "ck")).restore(host)
    for name, x in _flat(restored).items():
        assert np.array_equal(np.asarray(x), _flat(jax_side["state"])[name]), name


@pytest.mark.parametrize("shape,dtype,target", [
    ((92553, 2048), np.float32, 2**31), ((24, 2048, 8192), np.float32, 2**31),
    ((48, 6144, 16384), jnp.bfloat16, 2**31), ((7, 5, 3), np.float32, 64),
    ((1000,), np.int32, 100), ((), np.int32, 4), ((6, 10), np.float32, 24),
])
def test_chunk_shapes_are_orbax_s(shape, dtype, target):
    from orbax.checkpoint._src.arrays import subchunking
    from orbax.checkpoint._src.serialization import tensorstore_utils

    dtype = np.dtype(dtype)
    size = tensorstore_utils.calculate_chunk_byte_size(shape, dtype, chunk_byte_size=None,
                                                       ocdbt_target_data_file_size=target)
    want = subchunking.choose_chunk_shape(shape, shape, dtype, size)
    assert orbax_format.choose_chunk_shape(shape, dtype.itemsize, target) == tuple(want)


# ----------------------------------------------------------- layer decay --

def test_layer_decay_chain_with_bf16_frozen_towers(jax_side, tmp_path):
    """JAX's chain with the layer-decay link (a fourth state) and frozen
    towers in bf16, both ways."""
    kw = dict(vit_layer_decay_rate=0.9)
    jt = jtrainer.Trainer(AIGVAssessor(fx.config(), Precision()), jax_side["params"],
                          jtrainer.TrainConfig(grad_checkpoint=False, output_dir=str(tmp_path),
                                               **fx.TRAIN, **kw), fx.TOTAL_STEPS,
                          mesh=make_mesh(MeshConfig(data=1, fsdp=1)))
    host = jax.device_get(jt.state)
    assert len(host.opt_state) == 3
    jm = JaxManager(str(tmp_path / "jax"))
    jm.save(0, jt.state)
    jm.close()
    tree = _read(tmp_path / "jax" / "0" / "default")
    assert tree["params.params.vision_model.embeddings.patch_embedding.kernel"].dtype == torch.bfloat16
    _assert_tree_equal(tree, host)

    trainer = _port_trainer(tmp_path, precision=TorchPrecision(), **kw)
    assert trainer.layer_decay
    CheckpointManager(str(tmp_path / "jax")).restore(trainer)
    _assert_port_holds(trainer, host)
    CheckpointManager(str(tmp_path / "port")).save(0, trainer)
    with open(tmp_path / "port" / "0" / "default" / "_METADATA") as f:
        assert "('opt_state', '2')" in json.load(f)["tree_metadata"]
    restored = JaxManager(str(tmp_path / "port")).restore(host)
    for name, x in _flat(restored).items():
        want = _flat(host)[name]
        assert np.asarray(x).dtype == want.dtype and np.array_equal(np.asarray(x), want), name


def test_restore_refuses_another_model(jax_side, tmp_path):
    cfg = TorchConfig.tiny(stage=2).replace(img_context_token_id=fx.CTX)
    trainer = ttrainer.Trainer(TorchAssessor(cfg, TorchPrecision.fp32()),
                               ttrainer.TrainConfig(output_dir=str(tmp_path)), 3)
    with pytest.raises(KeyError, match="does not match the trainer"):
        CheckpointManager(str(jax_side["ckpt"])).restore(trainer)
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore(trainer)
