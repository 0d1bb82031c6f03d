"""The PyTorch port's configs and primitive ops against the JAX package.

Inputs come from a numpy seed and go through both functions in fp32; the
port must agree to atol 1e-5 (one rounding order apart at most).
"""

from tests import _torch_threads  # noqa: F401  (before torch does work)
import dataclasses
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aigv_assessor_torch.core import config as tcfg
from aigv_assessor_torch.ops import norms as tnorms
from aigv_assessor_torch.ops import pixel_shuffle as tps
from aigv_assessor_torch.ops import preprocess as tpre
from aigv_assessor_torch.ops import rope as trope
from aigv_assessor_torch.ops import splice as tsplice
from aigv_assessor_tpu.core import config as jcfg
from aigv_assessor_tpu.ops import norms as jnorms
from aigv_assessor_tpu.ops.pixel_shuffle import pixel_shuffle as jax_pixel_shuffle
from aigv_assessor_tpu.ops import preprocess as jpre
from aigv_assessor_tpu.ops import rope as jrope
from aigv_assessor_tpu.ops.splice import splice_image_embeds as jax_splice

ATOL = 1e-5
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(
        np.asarray(got, np.float32), np.asarray(want, np.float32), rtol=atol, atol=atol
    )


# ------------------------------------------------------------------ config --

CONFIG_CLASSES = ["VisionConfig", "RopeScaling", "LLMConfig", "MotionConfig", "LoRAConfig",
                  "AssessorConfig"]


@pytest.mark.parametrize("name", CONFIG_CLASSES)
def test_config_fields_match_jax(name):
    """Same field names, order and defaults as the JAX dataclass."""
    t_fields = dataclasses.fields(getattr(tcfg, name))
    j_fields = dataclasses.fields(getattr(jcfg, name))
    assert [f.name for f in t_fields] == [f.name for f in j_fields]
    assert dataclasses.asdict(getattr(tcfg, name)()) == dataclasses.asdict(
        getattr(jcfg, name)()
    )


@pytest.mark.parametrize("scale", ["tiny", "default", "2b"])
def test_config_values_and_properties_match_jax(scale):
    from aigv_assessor_tpu.cli.common import LLM_2B

    if scale == "tiny":
        t, j = tcfg.AssessorConfig.tiny(stage=2), jcfg.AssessorConfig.tiny(stage=2)
    elif scale == "2b":
        t, j = tcfg.AssessorConfig(llm=tcfg.LLM_2B), jcfg.AssessorConfig(llm=LLM_2B)
    else:
        t, j = tcfg.AssessorConfig(), jcfg.AssessorConfig()
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    for prop in ("num_image_token", "vit_hidden_size", "llm_hidden_size"):
        assert getattr(t, prop) == getattr(j, prop)
    for prop in ("head_dim", "num_patches_per_side", "num_patches"):
        assert getattr(t.vision, prop) == getattr(j.vision, prop)
    for prop in ("head_dim", "num_key_value_groups", "effective_qkv_bias", "effective_o_bias"):
        assert getattr(t.llm, prop) == getattr(j.llm, prop)


def test_train_config_fields_match_jax():
    """`TrainConfig`: same field names, order and defaults as the JAX one."""
    from aigv_assessor_torch.train.trainer import TrainConfig
    from aigv_assessor_tpu.train.trainer import TrainConfig as JaxTrainConfig

    assert [f.name for f in dataclasses.fields(TrainConfig)] == [
        f.name for f in dataclasses.fields(JaxTrainConfig)]
    assert dataclasses.asdict(TrainConfig()) == dataclasses.asdict(JaxTrainConfig())


def test_port_imports_without_jax():
    """Every module of the port (the scoring and training paths, the tools)
    and `chip_smoke.py` import in a process where jax, flax, optax, orbax,
    tensorstore and the JAX package cannot be imported; there the port reads
    the committed JAX-written checkpoint."""
    code = (
        "import sys, importlib, pkgutil\n"
        "for m in ('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'tensorstore',\n"
        "          'aigv_assessor_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import aigv_assessor_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(aigv_assessor_torch.__path__,\n"
        "                                               'aigv_assessor_torch.')]\n"
        "for needed in ('cli.score', 'cli.stage2_train', 'train.trainer', 'train.freeze',\n"
        "               'train.layer_decay', 'train.checkpoint', 'ops.flash_attention',\n"
        "               'ops.remat', 'ops.int8_matmul', 'tools.profile_score',\n"
        "               'models.loading', 'ops.kv_quant', 'ops.decode_attention',\n"
        "               'models.generation', 'data.conversation', 'data.preprocess',\n"
        "               'ops.fp8_matmul', 'tools.fp8_decode_probe', 'cli.args',\n"
        "               'cli.common', 'cli.stage1_eval', 'cli.stage2_eval',\n"
        "               'train.evaluate', 'data.dataset', 'data.collator',\n"
        "               'data.sampler', 'data.loader', 'data.storage',\n"
        "               'utils.flax_msgpack', 'tools.merge_lora', 'tools.extract_vit',\n"
        "               'tools.extract_mlp', 'tools.replace_llm', 'tools.resize_pos_embed',\n"
        "               'tools.convert_to_int8', 'tools.json2jsonl', 'tools.jsonl2jsonl',\n"
        "               'tools.convert_parquet', 'tools.extract_video_frames',\n"
        "               'tools.make_synthetic_ckpt', 'utils.zstd', 'utils.ocdbt',\n"
        "               'utils.orbax_format'):\n"
        "    assert 'aigv_assessor_torch.' + needed in names, needed\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "import chip_smoke\n"
        "from aigv_assessor_torch.utils import orbax_format\n"
        "tree = orbax_format.read_tree('tests/data/orbax_stage1/1/default')\n"
        "assert int(dict((orbax_format.leaf_name(k), t) for k, t in tree)['step']) == 1\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True,
        timeout=120,
    )
    assert proc.returncode == 0, proc.stderr


def test_kernel_library_is_stale_when_its_source_or_a_header_is_newer(tmp_path, monkeypatch):
    """`CudaLibrary.up_to_date`: a built library is rebuilt after an edit of
    its source or of any header in `csrc/` (the backward attention and the
    weight-only kernels share `mma_fragments.cuh`, the forward attention
    includes `hopper.cuh`)."""
    from aigv_assessor_torch.ops import cuda_build

    csrc, out = tmp_path / "csrc", tmp_path / "build"
    csrc.mkdir(), out.mkdir()
    monkeypatch.setattr(cuda_build, "CSRC", csrc)
    monkeypatch.setattr(cuda_build, "BUILD_DIR", out)
    source, header = csrc / "k.cu", csrc / "h.cuh"
    source.write_text("// kernel\n"), header.write_text("// helpers\n")
    lib = cuda_build.CudaLibrary("k.cu", lambda _: None)
    assert lib.path == out / "libk.so" and not lib.up_to_date()
    lib.path.write_bytes(b"")
    for age, f in ((30, source), (20, header), (10, lib.path)):  # seconds ago
        t = lib.path.stat().st_mtime - age
        os.utime(f, (t, t))
    assert lib.up_to_date()
    for newer in (source, header):
        t = lib.path.stat().st_mtime
        os.utime(newer, (t + 5, t + 5))
        assert not lib.up_to_date()
        os.utime(newer, (t - 5, t - 5))
    assert lib.up_to_date()
    # the shipped sources include the header from their own directory
    shipped = cuda_build.Path(cuda_build.__file__).resolve().parents[1] / "csrc"
    for name, header in (("flash_attn_fwd.cu", "hopper.cuh"),
                         ("flash_attn_bwd.cu", "hopper.cuh"),
                         ("weight_only_matmul.cu", "mma_fragments.cuh")):
        assert f'#include "{header}"' in (shipped / name).read_text()
        assert (shipped / header).exists()


def test_forward_attention_runs_on_wgmma_and_tma():
    """The flash-attention forward's source (both entries, one kernel body)
    issues its products as Hopper `wgmma` on TMA-loaded tiles and keeps no
    `mma.sync` path: its header's wrappers are the only PTX it issues."""
    from aigv_assessor_torch.ops import cuda_build

    csrc = cuda_build.Path(cuda_build.__file__).resolve().parents[1] / "csrc"
    fwd, header = (csrc / "flash_attn_fwd.cu").read_text(), (csrc / "hopper.cuh").read_text()
    # the instruction, not a word of a comment
    assert "mma.sync.aligned" not in fwd + header
    assert "mma_fragments" not in fwd and "mma_16816" not in fwd
    for wrapper in ("wgmma_ss_n128", "wgmma_rs_n128_mn", "wgmma_rs_n64_mn", "tma_load_4d",
                    "tma_store_4d", "setmaxnreg_inc", "mbar_wait"):
        assert wrapper + "(" in fwd or wrapper + "<" in fwd, wrapper
    for ptx in ("wgmma.mma_async.sync.aligned", "cp.async.bulk.tensor.4d", "setmaxnreg",
                "mbarrier.try_wait.parity", "fence.proxy.async"):
        assert ptx in header, ptx
    for entry in ("int aigv_flash_attn_qkv_fwd(", "int aigv_flash_attn_fwd("):
        assert entry in fwd


def test_attention_kernels_share_one_tile_layout_with_d96_of_its_own():
    """Both attention sources lay tiles out through `hopper.cuh`'s one
    `Layout<D>` (64-byte swizzle, 32-column boxes at D = 96), and the forward
    reaches a D = 96 instantiation of its own from both entries: its products
    run at the true width (m64n96 for P V and for S over 96-key tiles), and
    no route maps D = 96 onto the D = 128 body."""
    from aigv_assessor_torch.ops import cuda_build

    csrc = cuda_build.Path(cuda_build.__file__).resolve().parents[1] / "csrc"
    fwd, bwd, header = ((csrc / name).read_text()
                        for name in ("flash_attn_fwd.cu", "flash_attn_bwd.cu", "hopper.cuh"))
    assert "struct Layout {" in header
    assert "SW64 = D == 96" in header and "make_desc_sw64(tile, lbo, GROUP)" in header
    for source in (fwd, bwd):
        assert "struct Layout" not in source and "using L = Layout<D>;" in source
        assert "L::SW64 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B" in source
    assert "wgmma_rs_n96_mn(o, p, b)" in fwd and "wgmma_ss_n96(s, a, b, scale_d)" in fwd
    assert "D == 96 ? run(std::integral_constant<int, 96>())" in fwd
    assert "launch_bn<128, 128>" not in fwd and "launch_bn<128, 176>" not in fwd
    assert "BOX = 64" not in fwd


def test_causal_forward_is_one_persistent_form():
    """Every causal launch of the forward (K1 and K2, every head dim, with or
    without the logsumexp) takes one kernel: one persistent block an SM,
    dealt its items statically (no counter, no state between launches), q
    tiles aligned to the end of the sequence with the ragged one first and
    loaded from row 0; nothing reads the environment to pick a schedule. The
    non-causal launches keep their kernel and its grid of one block per (q
    tile, q head, sample), whose SASS tools/attention_ab.py holds to the
    parent's on the card."""
    from aigv_assessor_torch.ops import cuda_build
    from aigv_assessor_torch.ops import flash_attention as fa

    csrc = cuda_build.Path(cuda_build.__file__).resolve().parents[1] / "csrc"
    fwd = (csrc / "flash_attn_fwd.cu").read_text()
    wrapper = cuda_build.Path(fa.__file__).read_text()
    assert fwd.count("__global__ void") == 2
    assert "template <int D, int BN>\n__global__ void __launch_bounds__(block_threads(D), 1)\n" \
        "flash_fwd_kernel(" in fwd
    assert "auto kernel = flash_fwd_causal_kernel<D, BN>;" in fwd
    assert "auto kernel = flash_fwd_kernel<D, BN>;" in fwd
    assert "consumer<D, BN, false>(" in fwd and "consumer<D, BN, true>(" in fwd
    # the causal schedule: the ragged tile first, from row 0; one block an SM
    assert "w.end = Sq - band * BM;" in fwd and "w.q0 = max(w.end - BM, 0);" in fwd
    assert "kernel<<<min(n_items, sms)," in fwd and "cudaDevAttrMultiProcessorCount" in fwd
    assert "atomic" not in fwd
    # the non-causal grid and q tiles as they were
    assert "const dim3 grid((Sq + block_rows(D) - 1) / block_rows(D), hq, B);" in fwd
    assert "const int q0 = blockIdx.x * BM;" in fwd
    for source in (fwd, wrapper):
        assert "getenv" not in source and "environ" not in source


def test_backward_attention_runs_on_wgmma_and_tma():
    """The flash-attention backward's source (both entries) issues every
    product as Hopper `wgmma` on TMA-loaded tiles, computes delta in a launch
    of its own from `out` and keeps no `mma.sync` path."""
    from aigv_assessor_torch.ops import cuda_build

    csrc = cuda_build.Path(cuda_build.__file__).resolve().parents[1] / "csrc"
    bwd = (csrc / "flash_attn_bwd.cu").read_text()
    assert "mma.sync.aligned" not in bwd
    assert "mma_fragments" not in bwd and "mma_16816" not in bwd and "ldmatrix" not in bwd
    for wrapper in ("wgmma_ss_n64", "wgmma_rs_n128_mn", "wgmma_rs_n64_mn", "wgmma_ss_n128_tt",
                    "tma_load_4d", "tma_store_4d", "setmaxnreg_inc", "mbar_wait",
                    "flash_bwd_kernel", "flash_bwd_delta_kernel"):
        assert wrapper + "(" in bwd or wrapper + "<" in bwd, wrapper
    for entry in ("aigv_flash_attn_qkv_bwd", "aigv_flash_attn_bwd"):
        head = bwd[bwd.index(f"int {entry}("):]
        assert "const void* out" in head[: head.index(")")], entry  # delta from out, inside


def test_backward_is_one_kernel_a_key_tile():
    """One kernel a key tile computes dK, dV and dQ's share: no dq-only
    kernel or entry is left; dQ's shares go into the running sums by bulk
    copies and reductions in the order the q tile's counter sets (a wait on
    the counter before the add, a release after it), never by an unordered
    atomic; no switch or environment read selects another form."""
    from aigv_assessor_torch.ops import cuda_build

    csrc = cuda_build.Path(cuda_build.__file__).resolve().parents[1] / "csrc"
    bwd = (csrc / "flash_attn_bwd.cu").read_text()
    assert "flash_bwd_dq_kernel" not in bwd and "flash_bwd_dkv_kernel" not in bwd
    assert "_bwd_dq(" not in bwd and "_bwd_dkv(" not in bwd
    assert bwd.count("__global__") == 3  # delta, the key tiles' kernel, dq's convert
    start = bwd.index("void writer(")
    writer = bwd[start:bwd.index("__global__", start)]
    waited, added = writer.index("wait_counter("), writer.index("bulk_reduce_add_f32(")
    assert waited < added and "red_release_gpu_inc(" in writer and "bulk_wait_all()" in writer
    assert "atomicAdd" not in bwd and "atomicAdd" not in (csrc / "hopper.cuh").read_text()
    assert "red.global.add" not in bwd
    for source in (bwd, (csrc.parent / "ops" / "flash_attention.py").read_text()):
        assert "getenv" not in source and "environ" not in source


# ------------------------------------------------------------------- norms --


@pytest.mark.parametrize("kind", ["rms", "layer"])
def test_norms(kind):
    rng = np.random.default_rng(0)
    x = rng.normal(2.0, 3.0, (3, 5, 48)).astype(np.float32)
    w = rng.normal(1.0, 0.1, 48).astype(np.float32)
    b = rng.normal(0.0, 0.1, 48).astype(np.float32)
    if kind == "rms":
        got = tnorms.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-5)
        want = jnorms.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5)
    else:
        got = tnorms.layer_norm(
            torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b), 1e-6
        )
        want = jnorms.layer_norm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), 1e-6)
    _close(got, want)


# -------------------------------------------------------------------- rope --


@pytest.mark.parametrize(
    "seq_len,scaling", [(64, "dynamic"), (300, "dynamic"), (64, "linear"), (64, None)]
)
def test_rope_tables(seq_len, scaling):
    """seq_len 300 > max_position_embeddings 256 takes the NTK-scaled base."""
    kw = dict(base=10_000.0, scaling_type=scaling, scaling_factor=2.0,
              max_position_embeddings=256)
    assert trope.ntk_scaled_base(10_000.0, 16, seq_len, 256, 2.0) == pytest.approx(
        jrope.ntk_scaled_base(10_000.0, 16, seq_len, 256, 2.0)
    )
    tc, ts = trope.rope_cos_sin(seq_len, 16, **kw)
    jc, js = jrope.rope_cos_sin(seq_len, 16, **kw)
    _close(tc, jc)
    _close(ts, js)


def test_apply_rope_bhsd():
    rng = np.random.default_rng(1)
    b, hq, hkv, s, d = 2, 4, 2, 12, 16
    q = rng.normal(size=(b, hq, s, d)).astype(np.float32)
    k = rng.normal(size=(b, hkv, s, d)).astype(np.float32)
    pos = np.stack([np.arange(s), np.arange(3, 3 + s)]).astype(np.int32)
    jc, js = jrope.rope_cos_sin(32, d, base=10_000.0)
    tc, ts = trope.rope_cos_sin(32, d, base=10_000.0)
    gq, gk = trope.apply_rope(
        torch.from_numpy(q), torch.from_numpy(k), tc, ts, torch.from_numpy(pos).long()
    )
    wq, wk = jrope.apply_rope(
        jnp.asarray(q), jnp.asarray(k), jc, js, jnp.asarray(pos), layout="bhsd"
    )
    _close(gq, wq)
    _close(gk, wk)


def test_apply_rope_bshd():
    """The row-major layout the weight-only decoder runs (the JAX default)."""
    rng = np.random.default_rng(2)
    b, hq, hkv, s, d = 2, 4, 2, 12, 16
    q = rng.normal(size=(b, s, hq, d)).astype(np.float32)
    k = rng.normal(size=(b, s, hkv, d)).astype(np.float32)
    pos = np.stack([np.arange(s), np.arange(3, 3 + s)]).astype(np.int32)
    jc, js = jrope.rope_cos_sin(32, d, base=10_000.0)
    tc, ts = trope.rope_cos_sin(32, d, base=10_000.0)
    gq, gk = trope.apply_rope(
        torch.from_numpy(q), torch.from_numpy(k), tc, ts, torch.from_numpy(pos).long(),
        layout="bshd",
    )
    wq, wk = jrope.apply_rope(jnp.asarray(q), jnp.asarray(k), jc, js, jnp.asarray(pos))
    _close(gq, wq)
    _close(gk, wk)
    # a strided view, as the decoder slices q and k out of one projection
    proj = torch.from_numpy(rng.normal(size=(b, s, (hq + hkv) * d)).astype(np.float32))
    vq, vk = proj[..., : hq * d].view(b, s, hq, d), proj[..., hq * d :].view(b, s, hkv, d)
    cq, ck = trope.apply_rope(vq, vk, tc, ts, torch.from_numpy(pos).long(), layout="bshd")
    rq, rk = trope.apply_rope(vq.contiguous(), vk.contiguous(), tc, ts,
                              torch.from_numpy(pos).long(), layout="bshd")
    assert torch.equal(cq, rq) and torch.equal(ck, rk)
    with pytest.raises(ValueError, match="layout"):
        trope.apply_rope(vq, vk, tc, ts, torch.from_numpy(pos).long(), layout="sbhd")


# ----------------------------------------------------- pixel shuffle/splice --


@pytest.mark.parametrize("ps_version", ["v1", "v2"])
def test_pixel_shuffle(ps_version):
    x = np.random.default_rng(2).normal(size=(3, 4, 4, 8)).astype(np.float32)
    got = tps.pixel_shuffle(torch.from_numpy(x), 0.5, ps_version)
    want = jax_pixel_shuffle(jnp.asarray(x), 0.5, ps_version)
    assert tuple(got.shape) == want.shape
    _close(got, want, atol=0)


@pytest.mark.parametrize("with_motion", [True, False])
def test_splice(with_motion):
    rng = np.random.default_rng(3)
    b, n, c, n_vit, ctx = 2, 20, 8, 6, 7
    ids = rng.integers(10, 50, (b, n)).astype(np.int32)
    ids[0, 2:9] = ctx  # 7 slots: 6 ViT rows + motion in the last
    ids[1, [1, 4, 5, 8, 11, 12, 15]] = ctx  # scattered slots
    emb = rng.normal(size=(b, n, c)).astype(np.float32)
    vit = rng.normal(size=(b, n_vit, c)).astype(np.float32)
    motion = rng.normal(size=(b, c)).astype(np.float32) if with_motion else None
    got = tsplice.splice_image_embeds(
        torch.from_numpy(emb), torch.from_numpy(ids).long(), torch.from_numpy(vit), ctx,
        torch.from_numpy(motion) if with_motion else None,
    )
    want = jax_splice(
        jnp.asarray(emb), jnp.asarray(ids), jnp.asarray(vit), ctx,
        jnp.asarray(motion) if with_motion else None,
    )
    _close(got, want, atol=0)


# -------------------------------------------------------------- preprocess --


@pytest.mark.parametrize("normalize_type", ["imagenet", "clip"])
def test_normalize_matches_identity_resize(normalize_type):
    """The scoring path's `resize_normalize(size=frame size)`."""
    px = np.random.default_rng(4).integers(0, 256, (2, 3, 28, 28, 3), dtype=np.uint8)
    got = tpre.resize_normalize(
        torch.from_numpy(px), size=28, normalize_type=normalize_type, dtype=torch.float32
    )
    want = jpre.resize_normalize(
        jnp.asarray(px), size=28, normalize_type=normalize_type, dtype=jnp.float32
    )
    _close(got, want)


@pytest.mark.parametrize(
    "shape,dtype,exc",
    [
        ((2, 28, 30, 3), torch.uint8, None),  # not square: resized, as JAX
        ((2, 32, 32, 3), torch.uint8, None),  # another size: resized, as JAX
        ((2, 28, 28, 3), torch.float32, ValueError),  # not uint8
    ],
)
def test_normalize_rejects(shape, dtype, exc):
    """Frames that are not uint8 raise; frames of another size than the
    model's are resized (tests/test_torch_resize.py holds the resize to JAX
    at the scoring sizes)."""
    if exc is not None:
        with pytest.raises(exc):
            tpre.resize_normalize(torch.zeros(shape, dtype=dtype), size=28)
        return
    px = np.random.default_rng(5).integers(0, 256, shape, dtype=np.uint8)
    got = tpre.resize_normalize(torch.from_numpy(px), size=28, dtype=torch.float32)
    want = jpre.resize_normalize(jnp.asarray(px), size=28, dtype=jnp.float32)
    assert tuple(got.shape) == want.shape == (2, 28, 28, 3)
    _close(got, want, 1e-6 / min(jpre.NORMALIZE_STATS["imagenet"][1]))
