"""The `tensor` mesh axis in one process (`parallel/tensor.py`,
`parallel/sharding.tensor_plan`), fp32 on the CPU.

- Each module that splits (the ViT's attention, plain and QK-normalized at 4
  heads, and MLP; the decoder's GQA attention at 8 q / 4 kv heads, and MLP;
  each with and without adapters), cut for tensor 2 and 4 from one set of
  weights: the group-less shards' partial outputs summed, the bias added
  once, against JAX's module on the same weights within TOL = 1e-5
  relative. The QK-normalized attention needs the sum of squares over all
  heads inside the layer: its shards run on threads, one a rank, with the
  package's all-reduce replaced for the run by a sum over the threads
  (`ThreadGroup`); built group-less, it raises.
- The same shards in training (dropout 0.3 on the adapters): the summed
  output against the whole port module's with the same generator, and every
  gradient (each shard's gathered into the unsplit layout, and the input's)
  against the whole module's.
- The split plan against JAX's `param_spec` at (2, 2, 2) and (1, 1, 4) over
  every parameter of the tiny model and over the shapes of InternVL2-2B,
  -26B, -4B and -1B (built on the meta device): a tower projection splits
  exactly where JAX puts `tensor` on its kernel and the tower's heads
  divide; W8A8 / int8 / int4 bases and Phi-3 never split.
- The shards' parameters gathered bit-equal to the unsplit state dict, and
  a split input's dropout mask equal to the whole activation's.
"""

from tests import _torch_threads  # noqa: F401  (before torch does work)
import copy
import dataclasses
import sys
import threading
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from aigv_assessor_torch.core.config import LLM_2B, AssessorConfig
from aigv_assessor_torch.core.config import LLMConfig as TLLMConfig
from aigv_assessor_torch.core.config import LoRAConfig as TLoRAConfig
from aigv_assessor_torch.core.config import VisionConfig as TVisionConfig
from aigv_assessor_torch.core.precision import Precision as TPrecision
from aigv_assessor_torch.models import internlm2 as t_llm
from aigv_assessor_torch.models import vit as t_vit
from aigv_assessor_torch.models.assessor import AIGVAssessor
from aigv_assessor_torch.models.loading import init_random_, jax_paths
from aigv_assessor_torch.models.lora import dropout, set_generator
from aigv_assessor_torch.parallel.sharding import REPLICATED, split_towers_, tensor_plan
from aigv_assessor_torch.parallel.tensor import (
    COLUMN,
    ROW,
    SplitLinear,
    TensorSplit,
    split_leaves,
    sum_partials,
)
from aigv_assessor_torch.parallel import tensor as t_tensor
from aigv_assessor_tpu.core import config as j_cfg
from aigv_assessor_tpu.core.precision import Precision as JPrecision
from aigv_assessor_tpu.models import internlm2 as j_llm
from aigv_assessor_tpu.models import vit as j_vit
from aigv_assessor_tpu.ops.rope import rope_cos_sin as j_rope_cos_sin
from aigv_assessor_tpu.parallel.sharding import param_spec as j_param_spec

TOL = 1e-5
GRAD_TOL = 1e-5
TENSOR = (2, 4)
LORA = dict(r=2, alpha=4)
QK = dict(norm_type="rms_norm", qk_normalization=True, qkv_bias=False, initializer_factor=0.1)
GQA = dict(num_attention_heads=8, num_key_value_heads=4)  # D = 8, two q heads a group
B, N, KV_VALID, S = 2, 16, 13, 10


# --------------------------------------------------------------- modules --

def _configs(kind):
    """(port config, JAX config) of a module kind."""
    if kind.startswith("vit"):
        kw = QK if kind == "vit_qk_attn" else {}
        return (dataclasses.replace(TVisionConfig.tiny(), **kw),
                dataclasses.replace(j_cfg.VisionConfig.tiny(), **kw))
    return (dataclasses.replace(TLLMConfig.tiny(), **GQA),
            dataclasses.replace(j_cfg.LLMConfig.tiny(), **GQA))


def _port_module(kind, lora: bool):
    cfg, _ = _configs(kind)
    lcfg = TLoRAConfig(dropout=0.3, **LORA) if lora else None
    cls = {"vit_attn": t_vit.InternAttention, "vit_qk_attn": t_vit.InternAttention,
           "vit_mlp": t_vit.InternMLP, "llm_attn": t_llm.InternLM2Attention,
           "llm_mlp": t_llm.InternLM2MLP}[kind]
    m = cls(cfg, TPrecision.fp32(), lcfg)
    rng = np.random.default_rng(len(kind))
    with torch.no_grad():
        for name, p in m.named_parameters():
            if name.endswith("norm.weight"):
                v = rng.uniform(0.5, 1.5, tuple(p.shape))
            else:
                v = rng.normal(0, 0.2, tuple(p.shape))
            p.copy_(torch.from_numpy(v.astype(np.float32)))
    return m.eval()


def _jax_params(module):
    """The port module's weights as the JAX module's `{"params": ...}`."""
    tree = {}
    for name, t in module.state_dict().items():
        *mods, leaf = name.split(".")
        node = tree
        for m in mods:
            node = node.setdefault(m, {})
        v = t.detach().numpy()
        if leaf in ("weight", "bias") and not mods[-1].endswith("norm"):
            node = node.setdefault("base", {})
            if leaf == "weight":
                leaf, v = "kernel", v.T
        node[leaf] = jnp.asarray(v)
    return {"params": tree}


def _jax_module(kind, lora: bool):
    _, cfg = _configs(kind)
    lcfg = j_cfg.LoRAConfig(dropout=0.0, **LORA) if lora else None
    cls = {"vit_attn": j_vit.InternAttention, "vit_qk_attn": j_vit.InternAttention,
           "vit_mlp": j_vit.InternMLP, "llm_attn": j_llm.InternLM2Attention,
           "llm_mlp": j_llm.InternLM2MLP}[kind]
    return cls(cfg, JPrecision.fp32(), lcfg)


def _inputs(kind):
    """(port args, JAX args) of one call."""
    rng = np.random.default_rng(7)
    if kind.startswith("vit"):
        x = rng.normal(size=(B, N, 32)).astype(np.float32)
        if kind == "vit_mlp":
            return (torch.from_numpy(x),), (jnp.asarray(x),)
        return (torch.from_numpy(x), KV_VALID), (jnp.asarray(x), True, KV_VALID)
    x = rng.normal(size=(B, S, 64)).astype(np.float32)
    if kind == "llm_mlp":
        return (torch.from_numpy(x),), (jnp.asarray(x),)
    cfg, jcfg = _configs(kind)
    rs = jcfg.rope_scaling
    cos, sin = j_rope_cos_sin(S, jcfg.head_dim, base=jcfg.rope_theta, scaling_type=rs.type,
                              scaling_factor=rs.factor,
                              max_position_embeddings=jcfg.max_position_embeddings)
    pos = np.tile(np.arange(S), (B, 1))
    tcos, tsin = (torch.from_numpy(np.array(a)) for a in (cos, sin))
    return ((torch.from_numpy(x), tcos, tsin, torch.from_numpy(pos)),
            (jnp.asarray(x), cos, sin, jnp.asarray(pos)))


def _out(kind, y):
    return y[0] if kind == "llm_attn" else y


class ThreadGroup:
    """An in-process stand-in for the tensor axis' process group: each rank
    a thread, every all-reduce of the package (`parallel/tensor._all_reduce`,
    replaced for the run) the sum of the ranks' tensors in rank order (so
    every rank gets the same bits)."""

    def __init__(self, size):
        self.size = size
        self.barrier = threading.Barrier(size)
        self.slots = [None] * size
        self.local = threading.local()

    def all_reduce(self, t):
        self.slots[self.local.rank] = t
        self.barrier.wait()
        out = self.slots[0]
        for s in self.slots[1:]:
            out = out + s
        self.barrier.wait()
        return out

    def run(self, fn):
        """fn(rank) on every rank's thread, with the caller's grad mode ->
        the results in rank order."""
        results, errors = [None] * self.size, []
        grad = torch.is_grad_enabled()

        def body(r):
            self.local.rank = r
            try:
                with torch.set_grad_enabled(grad):
                    results[r] = fn(r)
            except BaseException as e:  # noqa: BLE001 - re-raised below
                errors.append(e)
                self.barrier.abort()

        threads = [threading.Thread(target=body, args=(r,)) for r in range(self.size)]
        with mock.patch.object(t_tensor, "_all_reduce", lambda t, group: group.all_reduce(t)):
            for t in threads:
                t.start()
            for t in threads:
                t.join()
        if errors:
            raise errors[0]
        return results


def _shards(module, t, group=None):
    out = []
    for r in range(t):
        sh = copy.deepcopy(module)
        sh.split_(TensorSplit(t, r, group))
        out.append(sh)
    return out


def _split_outputs(kind, module, t, args, train=False):
    """-> (the ranks' outputs combined into the whole layer's, the shards):
    group-less partials summed and the bias added once; the QK-normalized
    attention on threads, every rank's output whole."""
    def call(sh):
        if train:
            sh.train()
            set_generator(sh, torch.Generator().manual_seed(3))
        return _out(kind, sh(*args))

    if kind == "vit_qk_attn":
        group = ThreadGroup(t)
        shards = _shards(module, t, group)
        outs = group.run(lambda r: call(shards[r]))
        for o in outs[1:]:
            assert torch.equal(o, outs[0])
        return outs[0], shards
    shards = _shards(module, t)
    return sum_partials(shards[0], [call(sh) for sh in shards]), shards


KINDS = ("vit_attn", "vit_qk_attn", "vit_mlp", "llm_attn", "llm_mlp")


@pytest.mark.parametrize("t", TENSOR)
@pytest.mark.parametrize("lora", [False, True], ids=["base", "lora"])
@pytest.mark.parametrize("kind", KINDS)
def test_split_module_sums_to_jax(kind, lora, t):
    module = _port_module(kind, lora)
    args, jargs = _inputs(kind)
    with torch.no_grad():
        got, shards = _split_outputs(kind, module, t, args)
    want = np.asarray(_out(kind, _jax_module(kind, lora).apply(_jax_params(module), *jargs)))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL * np.abs(want).max())
    # each rank holds its share of the heads
    heads = {"vit_attn": "num_heads", "vit_qk_attn": "num_heads", "llm_attn": "hkv"}.get(kind)
    if heads:
        assert getattr(shards[0], heads) * t == getattr(module, heads)
    projections = [getattr(shards[0], c) for c in type(module).TENSOR_ROLES]
    assert all(p.split is not None for p in projections)
    if not lora:
        assert all(isinstance(p, SplitLinear) for p in projections)


def _grads(out, cot, x):
    (out * cot).sum().backward()
    return x.grad


@pytest.mark.parametrize("t", TENSOR)
@pytest.mark.parametrize("kind", KINDS)
def test_split_module_trains_as_whole(kind, t):
    """Adapters with dropout 0.3: the shards draw the whole activation's
    masks from one seed, so output, input gradient and every parameter's
    gradient (gathered) equal the whole module's."""
    module = _port_module(kind, lora=True)
    args, _ = _inputs(kind)
    x = args[0].clone().requires_grad_(True)
    whole = copy.deepcopy(module).train()
    set_generator(whole, torch.Generator().manual_seed(3))
    want = _out(kind, whole(x, *args[1:]))
    cot = torch.from_numpy(np.random.default_rng(9).normal(size=tuple(want.shape))
                           .astype(np.float32))
    want_dx = _grads(want, cot, x)

    xs = args[0].clone().requires_grad_(True)
    if kind == "vit_qk_attn":
        group = ThreadGroup(t)
        shards = _shards(module, t, group)

        def step(r):
            sh = shards[r].train()
            set_generator(sh, torch.Generator().manual_seed(3))
            xr = args[0].clone().requires_grad_(True)
            out = _out(kind, sh(xr, *args[1:]))
            (out * cot).sum().backward()
            return out.detach(), xr.grad

        res = group.run(step)
        got, got_dx = res[0]
        for out, dx in res[1:]:
            assert torch.equal(out, got) and torch.equal(dx, got_dx)
    else:
        got, shards = _split_outputs(kind, module, t, (xs, *args[1:]), train=True)
        got_dx = _grads(got, cot, xs)
        got = got.detach()
    want = want.detach()
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= TOL * scale
    assert float((got_dx - want_dx).abs().max()) <= GRAD_TOL * float(want_dx.abs().max())
    leaves = split_leaves(shards[0])
    params = [dict(sh.named_parameters()) for sh in shards]
    for name, p in whole.named_parameters():
        g = (leaves[name].unshard([ps[name].grad for ps in params]) if name in leaves
             else params[0][name].grad)
        if name not in leaves and kind != "vit_qk_attn":
            # a whole parameter's gradient is every shard's contribution summed
            # (the row-parallel bias, added once, has shard 0's alone)
            g = sum(ps[name].grad for ps in params if ps[name].grad is not None)
        assert g.shape == p.grad.shape, name
        err = float((g - p.grad).abs().max())
        assert err <= GRAD_TOL * float(p.grad.abs().max()) + 1e-12, (name, err)


def test_group_less_qk_norm_raises():
    """The QK-normalized attention's norms need the sum of squares over all
    heads, which summing the partials afterwards cannot give: a group-less
    shard refuses to run."""
    args, _ = _inputs("vit_qk_attn")
    shard = _shards(_port_module("vit_qk_attn", lora=False), 2)[0]
    with pytest.raises(ValueError, match="process group"), torch.no_grad():
        shard(*args)


# ------------------------------------------------------------------ plan --

TINY = dict(stage=2, use_backbone_lora=2, use_llm_lora=2)


def _big_configs():
    return {
        "2b": AssessorConfig(llm=LLM_2B, stage=2),
        "26b": chip_smoke.internvl2_26b(),
        "4b": chip_smoke.p15_config(chip_smoke.PHI3_MINI_128K),
        "1b": chip_smoke.p15_config(chip_smoke.QWEN2_05B),
    }


def _jax_mesh(shape):
    n = int(np.prod(shape))
    return jax.sharding.Mesh(np.asarray(jax.devices()[:n]).reshape(shape),
                             ("data", "fsdp", "tensor"))


def _jax_shape(path, shape, layer, n_layers):
    leaf = path.rpartition("/")[2]
    if leaf.startswith("kernel") and len(shape) == 2:
        shape = shape[::-1]
    elif leaf == "kernel" and len(shape) == 4:
        shape = (shape[2], shape[3], shape[1], shape[0])
    elif leaf == "kernel" and len(shape) == 5:
        shape = (shape[2], shape[3], shape[4], shape[1], shape[0])
    return ((n_layers,) if layer is not None else ()) + tuple(shape)


def _heads_divide(model, tower, t):
    cfg = model.config
    if tower == "vision_model":
        return cfg.vision.num_attention_heads % t == 0
    return cfg.llm.num_key_value_heads % t == 0


JAX_ONLY = ("language_model.output.weight", "motion_mlp.fc1.weight", "motion_mlp.fc2.weight")


def _check_plan(model, mesh_shape):
    """Every state-dict entry: JAX's spec against the port's plan."""
    t = mesh_shape[2]
    mesh = _jax_mesh(mesh_shape)
    plan = tensor_plan(model, dict(zip(("data", "fsdp", "tensor"), mesh_shape)))
    sd = model.state_dict()
    paths = jax_paths(model)
    layers = {"vision_model": model.config.vision.num_hidden_layers,
              "language_model": model.config.llm.num_hidden_layers}
    split_towers = set()
    for name, (path, layer) in paths.items():
        shape = _jax_shape(path, tuple(sd[name].shape), layer, layers.get(path.split("/")[0]))
        spec = j_param_spec("params/" + path, shape, mesh)
        jax_tensor = any(a == "tensor" or (isinstance(a, tuple) and "tensor" in a)
                         for a in spec if a is not None)
        module, leaf = name.rpartition(".")[::2]
        if module in plan and leaf == "weight":
            tower = name.split(".")[0]
            want = jax_tensor and _heads_divide(model, tower, t)
            assert (plan[module] != REPLICATED) == want, (name, spec, plan[module])
            if want:
                split_towers.add(tower)
        else:
            # JAX's other `tensor` leaves, which the port keeps whole on every
            # rank: the LM head where the vocabulary divides, and motion_mlp's
            # fc1 / fc2, which the ViT's `mlp/fc1`, `mlp/fc2` patterns match
            assert not jax_tensor or name in JAX_ONLY, (name, spec)
    return plan, split_towers


@pytest.mark.parametrize("mesh_shape", [(2, 2, 2), (1, 1, 4)], ids=["d2f2t2", "t4"])
def test_plan_follows_jax_on_the_tiny_model(mesh_shape):
    model = AIGVAssessor(AssessorConfig.tiny(**TINY), TPrecision.fp32())
    plan, towers = _check_plan(model, mesh_shape)
    # the tiny decoder's 2 kv heads divide by 2, not by 4
    assert towers == ({"vision_model", "language_model"} if mesh_shape[2] == 2
                      else {"vision_model"})
    assert set(plan.values()) >= {COLUMN, ROW}


@pytest.mark.parametrize("mesh_shape", [(2, 2, 2), (1, 1, 4)], ids=["d2f2t2", "t4"])
@pytest.mark.parametrize("name", ["2b", "26b", "4b", "1b"])
def test_plan_follows_jax_on_published_shapes(name, mesh_shape):
    cfg = _big_configs()[name]
    with torch.device("meta"):
        model = AIGVAssessor(cfg, TPrecision())
    _, towers = _check_plan(model, mesh_shape)
    t = mesh_shape[2]
    want = {
        # InternViT-300M: 16 heads; InternLM2-1.8B: 8 kv heads
        "2b": {"vision_model", "language_model"},
        # InternViT-6B: 25 heads divide by neither; internlm2-chat-20b: 8 kv heads
        "26b": {"language_model"},
        # Phi-3 is never split
        "4b": {"vision_model"},
        # Qwen2-0.5B: 2 kv heads
        "1b": {"vision_model"} | ({"language_model"} if t == 2 else set()),
    }[name]
    assert towers == want


@pytest.mark.parametrize("mode", ["w8a8", "int8", "int4"])
def test_quantized_bases_never_split(mode):
    from aigv_assessor_torch.models.loading import serving_precision

    precision = serving_precision(TPrecision.fp32(), **{mode: True})
    model = AIGVAssessor(AssessorConfig.tiny(**TINY), precision)
    plan, towers = _check_plan(model, (1, 1, 2))
    # W8A8 quantizes both towers; the weight-only modes the decoder alone
    assert towers == (set() if mode == "w8a8" else {"vision_model"})
    assert all(v == REPLICATED for k, v in plan.items() if k.startswith("language_model"))


def test_phi3_lists_nothing_to_split():
    with torch.device("meta"):
        model = AIGVAssessor(_big_configs()["4b"], TPrecision())
    plan = tensor_plan(model, {"tensor": 2})
    assert plan and not [k for k in plan if k.startswith("language_model")]
    shard = copy.deepcopy(AIGVAssessor(chip_smoke.p15_config(
        dict(chip_smoke.PHI3_MINI_128K, hidden_size=64, intermediate_size=128,
             num_attention_heads=4, num_key_value_heads=4, vocab_size=512), layers=1)
        .replace(vision=TVisionConfig.tiny()), TPrecision.fp32()))
    split_towers_(shard, TensorSplit(2, 0))
    assert not split_leaves(shard.language_model)
    assert split_leaves(shard.vision_model)


# --------------------------------------------------------------- layouts --

@pytest.mark.parametrize("t", TENSOR)
def test_gathered_state_dict_is_bit_equal(t):
    model = AIGVAssessor(AssessorConfig.tiny(**TINY), TPrecision.fp32())
    init_random_(model, 0)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("lora_b"):
                p.normal_(0, 0.1, generator=torch.Generator().manual_seed(hash(name) % 1000))
    whole = model.state_dict()
    shards = []
    for r in range(t):
        sh = copy.deepcopy(model)
        split_towers_(sh, TensorSplit(t, r))
        shards.append(sh.state_dict())
    leaves = split_leaves(sh)
    assert leaves and set(shards[0]) == set(whole)
    assert any(n.endswith(".attn.qkv.weight") for n in leaves)
    assert any(n.endswith(".attention.wqkv.lora_b") for n in leaves) == (t == 2)
    for name, w in whole.items():
        if name in leaves:
            assert shards[0][name].shape != w.shape
            got = leaves[name].unshard([s[name] for s in shards])
        else:
            got = shards[0][name]
        assert torch.equal(got, w), name


def test_qkv_split_keeps_each_ranks_heads():
    """wqkv at 8 q / 4 kv heads over 2 ranks: rank 1 holds q heads 4-7, k
    and v heads 2-3, each head's rows whole."""
    module = _port_module("llm_attn", lora=True)
    d = module.head_dim
    w = module.wqkv.weight.detach()
    sh = _shards(module, 2)[1]
    q, k, v = w[: 8 * d], w[8 * d: 12 * d], w[12 * d:]
    want = torch.cat([q[4 * d:], k[2 * d:], v[2 * d:]])
    assert torch.equal(sh.wqkv.weight, want)
    assert (sh.hq, sh.hkv, sh.wqkv.heads) == (4, 2, 8)
    assert torch.equal(sh.wqkv.lora_b, module.wqkv.lora_b.detach()[:, torch.cat([
        torch.arange(4 * d, 8 * d), torch.arange(10 * d, 12 * d), torch.arange(14 * d, 16 * d)])])
    assert torch.equal(sh.wo.weight, module.wo.weight.detach()[:, 4 * d:])
    assert torch.equal(sh.wo.lora_a, module.wo.lora_a.detach()[4 * d:])


@pytest.mark.parametrize("t", TENSOR)
def test_split_dropout_mask_is_the_whole_ones(t):
    x = torch.from_numpy(np.random.default_rng(3).normal(size=(2, 5, 16)).astype(np.float32))
    want = dropout(x, 0.3, torch.Generator().manual_seed(11))
    n = 16 // t
    for r in range(t):
        got = dropout(x[..., r * n:(r + 1) * n], 0.3, torch.Generator().manual_seed(11),
                      TensorSplit(t, r))
        assert torch.equal(got, want[..., r * n:(r + 1) * n])


if __name__ == "__main__":
    sys.exit(pytest.main([__file__, "-q"]))
