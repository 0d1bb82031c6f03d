"""The traced window's reduction, on a synthetic Chrome trace (times in us)."""

import pytest
import torch

from portbench import trace

HOST = {"pid": 1, "tid": 1}


def x(name, cat, ts, dur, **args):
    e = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, **HOST}
    if args:
        e["args"] = args
    return e


def device(name, cat, ts, dur, correlation=None):
    e = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "pid": 0, "tid": 7}
    if correlation is not None:
        e["args"] = {"correlation": correlation}
    return e


EVENTS = [
    x(trace.WINDOW, "user_annotation", 0, 1000),
    x(trace.MODULE_PREFIX + "vision_model", "user_annotation", 10, 390),
    x(trace.MODULE_PREFIX + "language_model", "user_annotation", 400, 500),
    x("cudaLaunchKernel", "cuda_runtime", 20, 5, correlation=1),
    x("cudaLaunchKernel", "cuda_runtime", 410, 5, correlation=2),
    x("cudaLaunchKernel", "cuda_runtime", 950, 5, correlation=3),
    x("cudaStreamSynchronize", "cuda_runtime", 690, 300),
    # the K1 forward and a cuBLAS GEMM that overlaps it by 50 us
    device("void flash_fwd_kernel<64, 128>(...)", "kernel", 100, 200, correlation=1),
    device("nvjet_tst_256x128_64x4_1x2_h_bz_coopA_TNT", "kernel", 250, 150, correlation=2),
    # an elementwise kernel launched outside every hooked module
    device("void at::native::elementwise_kernel<128, 2>(...)", "kernel", 600, 100, correlation=3),
    # a copy that runs past the window's end
    device("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", 980, 40),
    # a kernel wholly after the window
    device("void flash_fwd_kernel<64, 128>(...)", "kernel", 1100, 50, correlation=4),
]


def test_summary_of_a_synthetic_window():
    s = trace.summarize(EVENTS)
    assert s["window_s"] == pytest.approx(1000e-6)
    # union: [100, 400) + [600, 700) + [980, 1000)
    assert s["busy_s"] == pytest.approx(420e-6)
    assert s["kernels"] == 3
    assert s["by_kind"] == pytest.approx({"attention_fwd": 200e-6, "gemm": 150e-6,
                                          "elementwise_and_other": 100e-6,
                                          "memcpy_memset": 20e-6})
    assert s["by_module"] == pytest.approx({"vision_model": 200e-6, "language_model": 150e-6,
                                            "other": 100e-6})
    gaps = dict(s["breakdown"]["idle_gaps"])
    # [0, 100) outside every range; [400, 600) in the decoder's range;
    # [700, 980) inside the synchronize
    assert gaps == pytest.approx({"(host: outside any range)": 100e-6,
                                  trace.MODULE_PREFIX + "language_model": 200e-6,
                                  "cudaStreamSynchronize": 280e-6})
    ops = s["breakdown"]["device_ops"]
    assert ops[0] == ["void flash_fwd_kernel<64, 128>(...)", pytest.approx(200e-6)]
    assert len(ops) == 4


def test_short_gaps_are_summed_under_one_label():
    events = [x(trace.WINDOW, "user_annotation", 0, 200),
              device("gemm_a", "kernel", 0, 90), device("gemm_b", "kernel", 100, 100)]
    s = trace.summarize(events)
    assert s["busy_s"] == pytest.approx(190e-6)
    assert dict(s["breakdown"]["idle_gaps"]) == pytest.approx(
        {f"(gaps under {trace.GAP_LABEL_US:g} us)": 10e-6})


def test_a_trace_without_the_window_is_refused():
    with pytest.raises(ValueError):
        trace.summarize(EVENTS[1:])


def test_union_and_kinds():
    length, merged = trace.union_length([(5, 7), (0, 2), (1, 3), (7, 9), (4, 4)])
    assert length == 7 and merged == [(0, 3), (5, 9)]
    assert trace.kind_of("void flash_bwd_kernel<...>") == "attention_bwd"
    assert trace.kind_of("sm90_xmma_gemm_bf16bf16") == "gemm"
    assert trace.kind_of("cudnn::bn_fw_inf") == "cudnn"
    assert trace.kind_of("void at::native::vectorized_elementwise_kernel") == "elementwise_and_other"


def test_profile_window_and_module_ranges_on_the_cpu():
    """A real profiler window over hooked modules: the window is found; the
    CPU has no device time."""
    model = torch.nn.Sequential()
    model.add_module("vision_model", torch.nn.Linear(4, 4))
    handles = trace.hook_modules(model, ["vision_model"])
    with trace.profile_window(True) as prof:
        model(torch.ones(2, 4))
    for h in handles:
        h.remove()
    s = prof["summary"]
    assert s["window_s"] > 0 and s["busy_s"] == 0 and s["kernels"] == 0
    with trace.profile_window(False) as off:
        pass
    assert off == {}
