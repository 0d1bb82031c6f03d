"""The profilers' kernel kinds (`tools/profile_score.kind_of`, which
`tools/profile_generate.py` imports) on the kernel names `torch.profiler`
reports for the port's hand-written kernels: each lands in its own kind, the
causal forward of the decoders' prefill among them, and none in
`elementwise_and_other`."""

from tests import _torch_threads  # noqa: F401  (before torch does work)
import pytest

from aigv_assessor_torch.tools.profile_score import kind_of
from aigv_assessor_torch.tools.profile_train_step import kind_of as train_kind_of

ANON = "(anonymous namespace)"
NAMES = {
    f"void {ANON}::flash_fwd_kernel<128, 128>(CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, "
    "CUtensorMap_st, float*, int, int, int, int, float)": "attention_fwd",
    f"void {ANON}::flash_fwd_causal_kernel<128, 176>(CUtensorMap_st, CUtensorMap_st, "
    "CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, float*, int, int, int, int, int, int, int, "
    "float)": "attention_fwd",
    f"void {ANON}::gemm::weight_only_gemm_kernel<8>(CUtensorMap_st, CUtensorMap_st, "
    "CUtensorMap_st, float const*, __nv_bfloat16 const*, __nv_bfloat16*, int, int, int, "
    "long long, bool)": "weight_only_matmul",
    f"void {ANON}::gemm::weight_only_gemm_kernel<4>(CUtensorMap_st, CUtensorMap_st, "
    "CUtensorMap_st, float const*, __nv_bfloat16 const*, __nv_bfloat16*, int, int, int, "
    "long long, bool)": "weight_only_matmul",
    f"void decode_matvec::decode_matvec_kernel<{ANON}::Int8Weights>(__nv_bfloat16 const*, "
    "unsigned char const*, float const*, __nv_bfloat16 const*, __nv_bfloat16*, int, int, int, "
    "long long, long long, long long, bool, bool)": "weight_only_matmul",
    f"void decode_matvec::decode_matvec_kernel<{ANON}::Int4Weights>(__nv_bfloat16 const*, "
    "unsigned char const*, float const*, __nv_bfloat16 const*, __nv_bfloat16*, int, int, int, "
    "long long, long long, long long, bool, bool)": "weight_only_matmul",
    f"void {ANON}::unaligned::weight_only_matmul_kernel<8>(__nv_bfloat16 const*, unsigned char "
    "const*, float const*, __nv_bfloat16 const*, __nv_bfloat16*, int, int, int, long long, "
    "long long, long long, bool, bool)": "weight_only_matmul",
    f"void {ANON}::decode_attention_kernel<128, true, false>({ANON}::Params)": "decode_attention",
    "nvjet_tst_128x256_64x4_1x2_h_bz_coopA_NTT": "gemm",
    "void at::native::vectorized_elementwise_kernel<4, at::native::CUDAFunctor_add<float>, "
    "std::array<char*, 3ul> >(int, at::native::CUDAFunctor_add<float>, std::array<char*, "
    "3ul>)": "elementwise_and_other",
}


@pytest.mark.parametrize("name", list(NAMES), ids=lambda n: n.split("(")[0].split("::")[-1][:40])
def test_kernel_kinds(name):
    assert kind_of(name) == NAMES[name]


def test_training_profiler_files_both_forwards_as_attention():
    for name, kind in NAMES.items():
        if kind == "attention_fwd":
            assert train_kind_of(name) == "attention_fwd"
