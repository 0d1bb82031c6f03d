"""The weight-only matmuls (K6 int8, K7 int4) and the fp8 decode matvec (K9)
of this checkout against other versions of their sources, on one CUDA card,
in one process.

    python -m aigv_assessor_torch.tools.weight_only_ab [NAME=DIR ...]

Each DIR holds another `weight_only_matmul.cu` and `fp8_matmul.cu` (and the
headers they include), e.g. the parent commit's `aigv_assessor_torch/csrc`
unpacked with `git archive`. Every version, the checkout's own ("tree")
first, is built with nvcc (`-Xptxas -v`: registers and spills are printed).
A version whose library has the GEMM and GEMV entries is run in each of its
forms (`ops/int8_matmul._launch_form`); an older one through its single
entry, the name the unaligned form keeps.

Checks: every form of every version against `plain_int8_matmul` /
`plain_int4_matmul` in fp64 at small shapes that cross its borders
(relative L2 at most WO_TOL, an all-zero channel exactly 0); K9 against
`plain_fp8_matmul` (FP8_TOL).

Times, by CUDA graph replay, the versions in turns (tree, others, others
reversed, tree), with `F.linear` in bf16 on the dequantized weight in the
same process:
- M = 8452 at wqkv, wo, w1 (= w3) and w2: each version's GEMM form or its
  single kernel;
- M = 1, 4, 8 at the same projections, the fp8 probe's fused w13 (2048 ->
  16384) and the LM head (2048 -> 92553, M = 4): the GEMV form or the single
  kernel, cycling over weight copies that together exceed the 50 MB L2, as a
  decoder walking its layers finds them;
- the decode threshold: M = 4, 8, 16, 32, 64 at wqkv and w2, the tree's GEMV
  and GEMM forms over the same copies;
- K9 at the probe's three shapes and M = 1, 4, 8, over copies beyond L2.

Prints the card's name and power limit, then one JSON line per shape: ms per
call of each run, the bound (max of FLOPs / 989 TFLOP/s and bytes / 3.35
TB/s), TFLOP/s and `F.linear`'s ms. Exits 1 if a version disagrees with the
plain one. Needs a CUDA card; there is no CPU mode.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

# against the plain version in fp64: one bf16 rounding of each element,
# at most 2^-8 relative whatever the shape (chip_smoke.py holds the forms to
# 2e-3 and to the elementwise shares at larger shapes)
WO_TOL = 2.0**-8
FP8_TOL = 1e-3
PEAK_FLOPS, PEAK_BYTES = 989e12, 3.35e12
L2_BYTES = 50e6
PREFILL_ROWS = 4 * 2113
PROJECTIONS = {"wqkv": (2048, 4096), "wo": (2048, 2048), "w1": (2048, 8192),
               "w2": (8192, 2048)}
DECODE = {**PROJECTIONS, "w13": (2048, 16384)}
DECODE_ROWS = (1, 4, 8)
LM_HEAD = (2048, 92553)
THRESHOLD_ROWS = (4, 8, 16, 32, 64)
FP8_SHAPES = {"wqkv": (2048, 4096), "w13": (2048, 16384), "w2": (8192, 2048)}
# (M, K, N): one K step, ragged K steps (K = 160; K = 100 only unaligned), M
# across the GEMV blocks of 8 rows, the GEMV / GEMM threshold and the GEMM's
# 256-row tiles, N across the 16-channel blocks, the 64-channel consumer
# warpgroups and the 128-channel tiles, y's rows off 4 bytes
CHECKS = [(1, 64, 16), (8, 2048, 256), (9, 2048, 257), (16, 160, 255), (17, 64, 130),
          (64, 2048, 256), (65, 2048, 256), (127, 2048, 256), (128, 160, 512),
          (129, 2048, 384), (257, 2048, 129), (300, 2048, 511), (33, 100, 96)]


def graph_ms(fns, iters: int) -> float:
    """Device ms per call of `fns`, captured into one CUDA graph and replayed."""
    fns[0]()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for fn in fns:
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters / len(fns)


def bound(bits: int, m: int, k: int, n: int) -> float:
    """The least ms: FLOPs at the bf16 peak or bytes (x, weight, scale, y) at
    the memory rate, whichever is larger."""
    w_bytes = n * (k if bits == 8 else (k + 1) // 2)
    return max(2.0 * m * n * k / PEAK_FLOPS,
               (2 * m * k + w_bytes + 4 * n + 2 * m * n) / PEAK_BYTES) * 1e3


def relative_l2(x, y) -> float:
    return ((x.float() - y.float()).norm() / y.float().norm().clamp_min(1e-30)).item()


def main(argv=None) -> int:
    from aigv_assessor_torch.ops import cuda_build
    from aigv_assessor_torch.ops import fp8_matmul as f8
    from aigv_assessor_torch.ops import int8_matmul as wo

    if not torch.cuda.is_available():
        print("weight_only_ab needs a CUDA card", file=sys.stderr)
        return 1
    device = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)

    versions = {"tree": (wo.LIB, f8.LIB)}
    for arg in argv if argv is not None else sys.argv[1:]:
        name, _, folder = arg.partition("=")
        libs = []
        for source, declare in (("weight_only_matmul.cu", wo._declare),
                                ("fp8_matmul.cu", f8._declare)):
            lib = cuda_build.CudaLibrary(source, declare)
            lib.source = (Path(folder) / source).resolve()
            lib.path = cuda_build.BUILD_DIR / f"lib{Path(source).stem}_{name}.so"
            libs.append(lib)
        versions[name] = tuple(libs)
    every = [lib for pair in versions.values() for lib in pair]
    for lib in every:
        lib.path.unlink(missing_ok=True)
    cuda_build.build(every, verbose=True)
    # the forms each version's library has; an older library has only the
    # entries the unaligned form keeps
    forms = {}
    for name, (wlib, _) in versions.items():
        handle = ctypes.CDLL(str(wlib.path))
        forms[name] = [f for f in wo.FORMS if hasattr(handle, wo._ENTRIES[f].format(8))]
        wlib._declare = lambda lib, fs=tuple(forms[name]): wo._declare(lib, fs)

    gen = torch.Generator(device=device).manual_seed(0)

    def operands(bits, m, k, n):
        x = torch.randn((m, k), generator=gen, device=device).to(torch.bfloat16)
        w = torch.randn((n, k), generator=gen, device=device) * 0.02
        w[n // 2] = 0.0  # an all-zero channel: scale 1, output exactly 0
        q, s = (wo.quantize_weight if bits == 8 else wo.quantize_kernel_int4)(w)
        deq = (wo.dequantize_kernel(q, s, torch.bfloat16) if bits == 8 else
               wo.dequantize_kernel_int4(q, s, k, torch.bfloat16))
        return x, q, s, deq

    def use(name):
        wo.LIB, f8.LIB = versions[name]

    def run(form, bits, x, q, s):
        return wo._launch_form(form, bits, x, q, s)

    # checks
    ok = True
    for name in versions:
        use(name)
        for bits in (8, 4):
            plain = wo.plain_int8_matmul if bits == 8 else wo.plain_int4_matmul
            for m, k, n in CHECKS:
                x, q, s, _ = operands(bits, m, k, n)
                want = plain(x.double(), q, s, out_dtype=torch.float64)
                aligned = wo.weight_only_form(m, k, n, bits, x, q) != "unaligned"
                for form in [f for f in forms[name] if f != "gemm" or aligned]:
                    got = run(form, bits, x, q, s)
                    torch.cuda.synchronize()
                    rel = relative_l2(got, want)
                    good = (bool(torch.isfinite(got).all()) and rel <= WO_TOL
                            and not got[:, n // 2].any())
                    ok &= good
                    print(f"{name} int{bits} {form} M={m} K={k} N={n}: rel L2 "
                          f"{rel:.3e} {'ok' if good else 'FAILED'}", flush=True)
        for m in (1, 3, 8):
            k, n = 2050, 4100
            w = torch.randn((n, k), generator=gen, device=device) * 0.02
            w8, s8 = f8.quantize_weight_fp8(w)
            x = torch.randn((m, k), generator=gen, device=device).to(torch.bfloat16)
            rel = relative_l2(f8.fp8_matmul(x, w8, s8), f8.plain_fp8_matmul(x, w8, s8))
            ok &= rel <= FP8_TOL
            print(f"{name} fp8 M={m} K={k} N={n}: rel L2 {rel:.3e} "
                  f"{'ok' if rel <= FP8_TOL else 'FAILED'}", flush=True)

    order = list(versions) + list(versions)[::-1]

    def report(label, bits, m, k, n, runs, linear_ms, **extra):
        b = bound(bits, m, k, n)
        best = {key: min(v) for key, v in runs.items()}
        print(json.dumps({
            "shape": label, "bits": bits, "M": m, "K": k, "N": n, "ms": runs,
            "linear_ms": linear_ms, "bound_ms": b,
            "tflops": {key: 2e-9 * m * n * k / v for key, v in best.items()},
            "bound_share": {key: b / v for key, v in best.items()},
            "vs_linear": {key: v / linear_ms for key, v in best.items()}, **extra,
            "card": card}), flush=True)

    # prefill: the GEMM form (or an older version's single kernel)
    for bits in (8, 4):
        for label, (k, n) in PROJECTIONS.items():
            x, q, s, deq = operands(bits, PREFILL_ROWS, k, n)
            runs = {}
            for name in order:
                use(name)
                form = "gemm" if "gemm" in forms[name] else "unaligned"
                runs.setdefault(f"{name}/{form}", []).append(graph_ms(
                    [lambda f=form: run(f, bits, x, q, s)] * 3, 10))
            linear = graph_ms([lambda: F.linear(x, deq)] * 3, 10)
            report(label, bits, PREFILL_ROWS, k, n, runs, linear)
            del x, q, s, deq

    # decode and the threshold: weight copies beyond the L2
    def cycled(fn, weights, iters=20):
        return graph_ms([lambda w=w: fn(w) for w in weights], iters)

    decode_cases = [(label, m, k, n) for label, (k, n) in DECODE.items() for m in DECODE_ROWS]
    decode_cases.append(("lm_head", 4, *LM_HEAD))
    threshold = [(label, m, *PROJECTIONS[label])
                 for label in ("wqkv", "w2") for m in THRESHOLD_ROWS]
    for bits in (8, 4):
        for kind, cases in (("decode", decode_cases), ("threshold", threshold)):
            for label, m, k, n in cases:
                x, q, s, deq = operands(bits, m, k, n)
                copies = int(2 * L2_BYTES // q.numel()) + 1
                qs = [q] + [q.clone() for _ in range(copies - 1)]
                runs = {}
                for name in order if kind == "decode" else ["tree", "tree"]:
                    use(name)
                    if kind == "threshold":
                        variants = ["gemv", "gemm"]
                    else:
                        variants = ["gemv"] if "gemv" in forms[name] else ["unaligned"]
                    for form in variants:
                        runs.setdefault(f"{name}/{form}", []).append(
                            cycled(lambda w, f=form: run(f, bits, x, w, s), qs))
                del qs
                deqs = [deq] + [deq.clone() for _ in range(int(2 * L2_BYTES // (2 * deq.numel())))]
                linear = cycled(lambda w: F.linear(x, w), deqs)
                del deqs
                report(f"{kind}_{label}", bits, m, k, n, runs, linear, weight_copies=copies)
                del x, q, s, deq

    # K9
    for label, (k, n) in FP8_SHAPES.items():
        w = torch.randn((n, k), generator=gen, device=device) * 0.02
        w8, s8 = f8.quantize_weight_fp8(w)
        deq = f8.dequantize_weight_fp8(w8, s8, torch.bfloat16)
        copies = int(2 * L2_BYTES // w8.numel()) + 1
        ws = [w8] + [w8.clone() for _ in range(copies - 1)]
        for m in DECODE_ROWS:
            x = torch.randn((m, k), generator=gen, device=device).to(torch.bfloat16)
            runs = {}
            for name in order:
                use(name)
                runs.setdefault(f"{name}/fp8", []).append(
                    cycled(lambda w_, x=x: f8.fp8_matmul(x, w_, s8), ws))
            deqs = [deq] + [deq.clone() for _ in range(copies // 2)]
            linear = cycled(lambda w_, x=x: F.linear(x, w_), deqs)
            del deqs
            b = max(2.0 * m * n * k / PEAK_FLOPS,
                    (2 * m * k + n * k + 4 * n + 2 * m * n) / PEAK_BYTES) * 1e3
            print(json.dumps({"shape": f"fp8_{label}", "M": m, "K": k, "N": n, "ms": runs,
                              "linear_ms": linear, "bound_ms": b,
                              "bound_share": {key: b / min(v) for key, v in runs.items()},
                              "weight_copies": copies, "card": card}), flush=True)
        del ws
    use("tree")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
