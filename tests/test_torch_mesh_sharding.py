"""The port's multi-device layer in one process (`core/dist.py`,
`core/mesh.py`, `parallel/sharding.py`, `utils/logging_utils.py`,
`utils/profiling.py`, the mesh flags), against the JAX package where it has
the same function.

`param_spec` is held, for every parameter of the tiny InternLM2, Phi-3 and
tied Qwen2 models (LoRA on both towers), to JAX's `param_spec` on the JAX
tree's leaf over a JAX mesh of the same axis sizes (the 8 virtual CPU
devices of tests/conftest.py), its axes carried to the port's layout: a
dense kernel [in, out] is the port's weight [out, in], a conv kernel
[*k, in, out] its weight [out, in, *k], a layer's leaf drops JAX's stacked
layer dim. The layout map is checked on the shapes too. Exact equality.
"""

from tests import _torch_threads  # noqa: F401  (before torch does work)
import dataclasses
import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aigv_assessor_torch.cli import args as t_args
from aigv_assessor_torch.cli import common as t_common
from aigv_assessor_torch.core import dist as t_dist
from aigv_assessor_torch.core import mesh as t_mesh
from aigv_assessor_torch.core.config import AssessorConfig as TorchConfig
from aigv_assessor_torch.core.config import LLMConfig as TorchLLMConfig
from aigv_assessor_torch.core.config import Phi3Config as TorchPhi3Config
from aigv_assessor_torch.core.precision import Precision as TorchPrecision
from aigv_assessor_torch.models.assessor import AIGVAssessor as TorchAssessor
from aigv_assessor_torch.models.loading import jax_paths
from aigv_assessor_torch.parallel import sharding as t_sharding
from aigv_assessor_torch.utils import logging_utils, profiling
from aigv_assessor_tpu.cli import args as j_args
from aigv_assessor_tpu.cli import common as j_common
from aigv_assessor_tpu.core import mesh as j_mesh
from aigv_assessor_tpu.core.config import AssessorConfig, LLMConfig
from aigv_assessor_tpu.core.precision import Precision
from aigv_assessor_tpu.models.assessor import AIGVAssessor
from aigv_assessor_tpu.models.phi3 import Phi3Config
from aigv_assessor_tpu.parallel import sharding as j_sharding

from tests.test_torch_decoders import QWEN2

CTX = 7
LORA = dict(use_backbone_lora=2, use_llm_lora=2)
# (data, fsdp, tensor) over the 8 virtual devices; 3 leaves most dims indivisible
MESHES = [(1, 2, 1), (2, 2, 1), (1, 4, 1), (1, 8, 1), (1, 3, 1), (2, 1, 2), (1, 2, 4)]
DECODERS = {
    "internlm2": (lambda: None, lambda: None),
    "phi3": (Phi3Config.tiny, TorchPhi3Config.tiny),
    "qwen2_tied": (lambda: LLMConfig.from_dict(QWEN2), lambda: TorchLLMConfig.from_dict(QWEN2)),
}


def _models(decoder):
    """(JAX leaf shapes by path, the port's fp32 model) of the tiny stage-2
    model with `decoder`, built on the meta device / by shape only."""
    j_llm, t_llm = DECODERS[decoder]
    jkw = dict(LORA, llm=j_llm()) if j_llm() is not None else dict(LORA)
    tkw = dict(LORA, llm=t_llm()) if t_llm() is not None else dict(LORA)
    cfg = AssessorConfig.tiny(stage=2).replace(img_context_token_id=CTX, **jkw)
    tcfg = TorchConfig.tiny(stage=2).replace(img_context_token_id=CTX, **tkw)
    model = AIGVAssessor(cfg, Precision.fp32())
    n = 2 * cfg.num_image_token + 1 + 8
    shapes = jax.eval_shape(model.init, jax.random.key(0), jnp.zeros((1, n), jnp.int32),
                            jnp.zeros((1, 2, 56, 56, 3), jnp.float32))
    flat = {"/".join(str(getattr(k, "key", k)) for k in path): leaf.shape
            for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]}
    with torch.device("meta"):
        port = TorchAssessor(tcfg, TorchPrecision.fp32())
    return flat, port


def _to_port(spec, jshape, pshape, path, stacked):
    """JAX's spec of a leaf in the port's layout, after checking that the
    port's shape is the JAX shape so permuted."""
    spec = tuple(spec) + (None,) * (len(jshape) - len(spec))
    if stacked:
        spec, jshape = spec[1:], jshape[1:]
    n = len(jshape)
    perm = tuple(range(n))
    if path.endswith("kernel") and n >= 2:
        perm = (n - 1, n - 2) + tuple(range(n - 2))  # port dim d <- JAX dim perm[d]
    assert tuple(pshape) == tuple(jshape[j] for j in perm), (path, jshape, pshape)
    return tuple(spec[j] for j in perm)


@pytest.mark.parametrize("decoder", list(DECODERS))
def test_param_spec_equals_jax_for_every_parameter(decoder):
    flat, port = _models(decoder)
    paths = jax_paths(port)
    jmeshes = {m: j_mesh.make_mesh(j_mesh.MeshConfig(*m)) for m in MESHES}
    names = [n for n, _ in port.named_parameters()]
    assert len(names) > 100
    sharded = 0
    for name in names:
        path, layer = paths[name]
        jshape = flat["params/" + path]
        pshape = tuple(dict(port.named_parameters())[name].shape)
        for m, jm in jmeshes.items():
            want = _to_port(j_sharding.param_spec("params/" + path, jshape, jm), jshape, pshape,
                            path, layer is not None)
            got = t_sharding.param_spec(name, pshape, t_mesh.MeshConfig(*m))
            assert got == want, (name, path, m, got, want)
            sharded += any(a is not None for a in got)
    assert sharded > len(names)  # the rules shard a good part of the model


def test_param_spec_takes_axis_sizes_in_every_form():
    name, shape = "language_model.layers.0.attention.wqkv.weight", (128, 64)
    want = (None, "fsdp")  # JAX's column rule: fsdp on `in`, the port's dim 1
    for sizes in (t_mesh.MeshConfig(1, 2, 1), {"fsdp": 2}, {"data": 1, "fsdp": 2, "tensor": 1}):
        assert t_sharding.param_spec(name, shape, sizes) == want
    assert t_sharding.fsdp_dim(name, shape, {"fsdp": 2}) == 1
    assert t_sharding.fsdp_dim(name, shape, {"fsdp": 1}) is None
    assert t_sharding.jax_path(name, 2) == (
        "language_model/layers/attention/wqkv/base/kernel", True, (1, 0))


def test_mesh_config():
    c = t_mesh.MeshConfig(data=2, fsdp=3)
    assert c.num_devices == 6 and c.shape == {"data": 2, "fsdp": 3, "tensor": 1}
    assert t_mesh.MeshConfig.auto(4) == t_mesh.MeshConfig(4, 1, 1)
    assert t_mesh.MeshConfig.auto(4, fsdp=True) == t_mesh.MeshConfig(1, 4, 1)
    for n, fsdp in ((4, False), (4, True), (8, True)):
        j = j_mesh.MeshConfig.auto(n, fsdp=fsdp)
        assert dataclasses.asdict(t_mesh.MeshConfig.auto(n, fsdp=fsdp)) == dataclasses.asdict(j)
    assert t_mesh.MeshConfig.auto() == t_mesh.MeshConfig(1, 1, 1)  # no group: one process
    assert t_mesh.MESH_AXES == j_mesh.MESH_AXES
    with pytest.raises(ValueError, match="only 2 available"):
        t_mesh.check_mesh(t_mesh.MeshConfig(1, 4), world=2)
    with pytest.raises(ValueError, match="every rank"):
        t_mesh.check_mesh(t_mesh.MeshConfig(1, 2), world=4)
    with pytest.raises(RuntimeError, match="process group"):
        t_mesh.make_mesh(t_mesh.MeshConfig())
    assert [type(p).__name__ for p in t_mesh.batch_spec()] == ["Shard", "Shard"]
    assert [type(p).__name__ for p in t_mesh.replicated()] == ["Replicate", "Replicate"]


def _argv(*mesh):
    return ["--meta_path", "m.json", *mesh]


@pytest.mark.parametrize("flags", [(), ("--mesh_fsdp", "2"), ("--mesh_fsdp", "4"),
                                   ("--mesh_data", "2", "--mesh_fsdp", "4"),
                                   ("--mesh_fsdp", "8")])
def test_mesh_from_args_lays_out_as_jax(flags):
    """Over 8 ranks, the flags give JAX's mesh over its 8 devices."""
    want = j_common.mesh_from_args(j_args.parse_args("x", _argv(*flags))).shape
    got = t_common.mesh_config_from_args(t_args.parse_args("x", _argv(*flags)), world=8)
    assert got.shape == dict(want)


def test_mesh_flags_without_a_group():
    args = t_args.parse_args("x", _argv("--mesh_data", "1", "--mesh_fsdp", "1"))
    assert t_common.mesh_from_args(args) is None
    with pytest.raises(ValueError, match="only 1 available"):
        t_common.mesh_from_args(t_args.parse_args("x", _argv("--mesh_fsdp", "2")))


def test_mesh_tensor_raises_naming_the_queue():
    """`--mesh_tensor 2` parses as JAX's parser parses it; at world 1 the
    mesh it asks for raises "only 1 available", as `--mesh_data` and
    `--mesh_fsdp` above 1 do."""
    args = t_args.parse_args("x", _argv("--mesh_data", "2", "--mesh_fsdp", "4"))
    assert (args.mesh_data, args.mesh_fsdp, args.mesh_tensor) == (2, 4, 1)
    args = t_args.parse_args("x", _argv("--mesh_tensor", "2"))
    assert vars(args) == {**vars(j_args.parse_args("x", _argv("--mesh_tensor", "2"))),
                          "device": args.device}
    assert args.mesh_tensor == 2
    with pytest.raises(ValueError, match="only 1 available"):
        t_common.mesh_from_args(args)
    with pytest.raises(ValueError):
        t_args.parse_args("x", _argv("--mesh_fsdp", "0"))


@pytest.mark.parametrize("env,kw,want", [
    ({}, {}, None),
    ({"WORLD_SIZE": "1", "RANK": "0"}, {}, None),
    ({"JAX_NUM_PROCESSES": "1"}, {}, None),
    ({"MASTER_ADDR": "localhost", "MASTER_PORT": "29500", "WORLD_SIZE": "1", "RANK": "0",
      "LOCAL_RANK": "0"}, {}, ("localhost:29500", 1, 0, 0)),
    ({"MASTER_ADDR": "h", "MASTER_PORT": "1", "WORLD_SIZE": "4", "RANK": "3",
      "LOCAL_RANK": "1"}, {}, ("h:1", 4, 3, 1)),
    ({"JAX_COORDINATOR_ADDRESS": "c:9", "JAX_NUM_PROCESSES": "2", "JAX_PROCESS_ID": "1"}, {},
     ("c:9", 2, 1, None)),
    ({"JAX_COORDINATOR_ADDRESS": "c:9", "JAX_NUM_PROCESSES": "2", "JAX_PROCESS_ID": "1"},
     dict(coordinator_address="d:8", process_id=0), ("d:8", 2, 0, None)),
    ({}, dict(coordinator_address="d:8", num_processes=8, process_id=5), ("d:8", 8, 5, None)),
])
def test_dist_env_reads_torchrun_and_jax_variables(env, kw, want):
    got = t_dist.dist_env(environ=env, **kw)
    assert got == (None if want is None else t_dist.DistEnv(*want))


def test_dist_env_refuses_half_a_launch():
    with pytest.raises(ValueError, match="process id"):
        t_dist.dist_env(environ={"JAX_COORDINATOR_ADDRESS": "c:9", "JAX_NUM_PROCESSES": "2"})


def test_single_process_builds_no_group(monkeypatch):
    for key in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT", "JAX_COORDINATOR_ADDRESS",
                "JAX_NUM_PROCESSES", "JAX_PROCESS_ID"):
        monkeypatch.delenv(key, raising=False)
    monkeypatch.setattr(t_dist, "_INITIALIZED", False)
    t_dist.init_dist(device="cpu")
    t_dist.init_dist(device="cpu")
    assert not torch.distributed.is_initialized()
    assert (t_dist.process_index(), t_dist.process_count(), t_dist.is_primary()) == (0, 1, True)
    assert t_dist.all_ranks_true(torch.tensor(True))
    assert not t_dist.all_ranks_true(torch.tensor(False))
    assert t_dist.broadcast_object({"a": 1}) == {"a": 1}
    t = torch.ones(2)
    assert t_dist.all_reduce_sum_(t) is t and t.tolist() == [1.0, 1.0]


def test_shard_batch_moves_rows():
    batch = {"input_ids": np.arange(6).reshape(2, 3), "name": "x"}
    got = t_sharding.shard_batch(batch, t_mesh.MeshConfig(), device=torch.device("cpu"))
    assert got["name"] == "x" and torch.equal(got["input_ids"], torch.arange(6).reshape(2, 3))


def test_setup_logging_tags_the_process(capsys):
    logger = logging_utils.setup_logging()
    assert logger.name == "aigv_assessor_torch"
    logging.getLogger("aigv_assessor_torch.x").info("hello")
    out = capsys.readouterr().out
    assert "[p0/1] INFO aigv_assessor_torch.x: hello" in out
    assert logging.getLogger().level == logging.INFO
    logging.basicConfig(force=True)  # leave the root logger as pytest had it


def test_step_timer_and_trace(tmp_path):
    calls = []
    timer = profiling.StepTimer(sync_fn=lambda: calls.append(1))
    for _ in range(3):
        with timer.step():
            pass
    s = timer.summary()
    assert s["steps"] == 3 and len(calls) == 6 and 0 <= s["p50_s"] <= s["max_s"]
    timer.save(str(tmp_path / "t.json"))
    assert profiling.StepTimer().sync_fn is None  # no card here
    with profiling.trace(str(tmp_path / "tr")):
        with profiling.annotate("region"):
            torch.ones(4).sum()
    assert os.path.getsize(tmp_path / "tr" / "trace.json") > 0
