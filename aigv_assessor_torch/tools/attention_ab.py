"""The flash-attention forward of this checkout against other versions of
its source, on one CUDA card, in one process.

    python -m aigv_assessor_torch.tools.attention_ab [NAME=DIR ...]

Each DIR holds another `flash_attn_fwd.cu` (and the headers it includes),
e.g. the parent commit's `aigv_assessor_torch/csrc` unpacked with `git
archive`. Every version, the checkout's own ("tree") first, is built with
nvcc (`-Xptxas -v`: registers and spills are printed) and held against
`plain_attention_qkv` at small shapes that cross its tile borders (output
to atol = rtol = 2e-2, logsumexp to 1e-4); then each of the scoring path's
shapes is timed by CUDA graph replay (3 launches per graph), the versions in
turns (tree, others, others reversed, tree), with SDPA on the same views in
the same process. Prints the card's name and power limit, then one JSON line
per shape: ms per launch of each run, share of the bound (FLOPs / 989
TFLOP/s), SDPA's ms. Exits 1 if a version disagrees with the plain one.

Needs a CUDA card; there is no CPU mode.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import torch

TOL, LSE_TOL = 2e-2, 1e-4
PEAK_FLOPS = 989e12
# (B, hq, hkv, S, D, causal, kv_valid)
CHECKS = [
    (1, 2, 2, 1, 64, False, None), (2, 4, 4, 200, 64, False, 150), (2, 4, 2, 200, 128, True, None),
    (1, 2, 2, 129, 128, True, None), (1, 12, 2, 257, 128, True, None),
    (1, 2, 2, 300, 64, False, 1), (2, 4, 4, 1032, 64, False, 1025),
    (1, 4, 4, 40, 128, True, None), (1, 4, 4, 65, 64, False, 65),
    (1, 4, 4, 700, 128, False, 600), (1, 4, 4, 1000, 64, True, None),
]
# the 2B ViT and LLM, InternViT-6B and internlm2-chat-20b (InternVL2-26B)
TIMED = {
    "vit_2b": (32, 16, 16, 1032, 64, False, 1025),
    "llm_2b": (4, 16, 8, 2113, 128, True, None),
    "vit_6b": (32, 25, 25, 1032, 128, False, 1025),
    "llm_20b": (4, 48, 8, 2113, 128, True, None),
}


def make_qkv(shape, device) -> torch.Tensor:
    b, hq, hkv, s, d, _, kv_valid = shape
    gen = torch.Generator(device=device).manual_seed(0)
    qkv = torch.randn((b, hq + 2 * hkv, s, d), generator=gen, device=device)
    if kv_valid is not None:  # a garbage tail: +-1e3 in k and v
        qkv[:, hq : hq + hkv, kv_valid:] = 1e3
        qkv[:, hq + hkv :, kv_valid:] = -1e3
    return qkv.to(torch.bfloat16)


def flops(shape) -> float:
    b, hq, _, s, d, causal, kv_valid = shape
    pairs = s * (s + 1) // 2 if causal else s * (kv_valid or s)
    return 4.0 * b * hq * pairs * d


def graph_ms(fn, iters: int = 20) -> float:
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(3):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters / 3


def main(argv=None) -> int:
    from aigv_assessor_torch.ops import cuda_build
    from aigv_assessor_torch.ops import flash_attention as fa

    if not torch.cuda.is_available():
        print("attention_ab needs a CUDA card", file=sys.stderr)
        return 1
    device = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    versions = {"tree": fa.LIB}
    for arg in argv if argv is not None else sys.argv[1:]:
        name, _, folder = arg.partition("=")
        lib = cuda_build.CudaLibrary("flash_attn_fwd.cu", fa._declare)
        lib.source = (Path(folder) / "flash_attn_fwd.cu").resolve()
        lib.path = cuda_build.BUILD_DIR / f"libflash_attn_fwd_{name}.so"
        versions[name] = lib
    for lib in versions.values():
        lib.path.unlink(missing_ok=True)
    cuda_build.build(list(versions.values()), verbose=True)

    ok = True
    for name, lib in versions.items():
        fa.LIB = lib
        for shape in CHECKS:
            _, hq, hkv, _, _, causal, kv_valid = shape
            qkv = make_qkv(shape, device)
            out, lse = fa.flash_attention_qkv_lse(qkv, hq, hkv, causal=causal, kv_valid=kv_valid)
            want, want_lse = fa.plain_attention_qkv(qkv, hq, hkv, causal=causal,
                                                    kv_valid=kv_valid, return_lse=True)
            err = (out.float() - want.float()).abs().max().item()
            lse_err = (lse - want_lse).abs().max().item()
            good = (torch.allclose(out.float(), want.float(), atol=TOL, rtol=TOL)
                    and lse_err <= LSE_TOL)
            ok &= good
            print(f"{name} {shape}: max_abs_err {err:.3e}, lse {lse_err:.3e} "
                  f"{'ok' if good else 'FAILED'}", flush=True)
    order = list(versions) + list(versions)[::-1]
    for label, shape in TIMED.items():
        _, hq, hkv, _, _, causal, kv_valid = shape
        qkv = make_qkv(shape, device)
        runs = {}
        for name in order:
            fa.LIB = versions[name]
            runs.setdefault(name, []).append(graph_ms(
                lambda: fa.flash_attention_qkv(qkv, hq, hkv, causal=causal, kv_valid=kv_valid)))
        q, k, v = qkv[:, :hq], qkv[:, hq : hq + hkv, :kv_valid], qkv[:, hq + hkv :, :kv_valid]
        with torch.no_grad():
            sdpa_ms = graph_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                q, k, v, is_causal=causal, enable_gqa=hq != hkv))
        bound = flops(shape) / PEAK_FLOPS * 1e3
        print(json.dumps({"shape": label, "dims": shape, "ms": runs, "sdpa_ms": sdpa_ms,
                          "bound_ms": bound,
                          "bound_share": {n: bound / min(t) for n, t in runs.items()},
                          "card": card}), flush=True)
        del qkv
    fa.LIB = versions["tree"]
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
