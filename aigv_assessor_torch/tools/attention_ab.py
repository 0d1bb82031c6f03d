"""The flash-attention forward of this checkout against other versions of
its source, on one CUDA card, in one process.

    python -m aigv_assessor_torch.tools.attention_ab [--check-only] [--shapes A,B]
        [NAME=DIR ...]

Each DIR holds another `flash_attn_fwd.cu` (and the headers it includes),
e.g. the parent commit's `aigv_assessor_torch/csrc` unpacked with `git
archive`. Every version, the checkout's own ("tree") first, is built with
nvcc (`-Xptxas -v`: registers and spills are printed) and held against
`plain_attention_qkv` at small shapes that cross its tile borders (output
to atol = rtol = 2e-2, logsumexp to 1e-4), at D = 64, 96 and 128, among
them the causal borders of the 192- and 128-row q tiles, which the causal
kernel aligns to the end of the sequence (the ragged tile first); then each
of the scoring and training paths' shapes (those named by `--shapes`, else
all; none with `--check-only`) is timed by CUDA graph replay (3 launches per
graph), the versions in turns (tree, others, others reversed, tree), with
SDPA's forward on the same views in the same process. `llm_4b_train` and
`llm_1b_train` are timed in the logsumexp form the training path runs.
Prints the card's name and power limit; a line per check shape and per timed
shape saying whether each other version's `out` and logsumexp are bit-equal
to the tree's on the same inputs; one JSON line per timed shape: ms per
launch of each run, share of the bound (FLOPs / 989 TFLOP/s), SDPA's ms;
last, per other version, which of its kernels compile to the same SASS in
the tree (`sass_in_tree`, as in tools/decode_attention_ab.py). Exits 1 if a
version disagrees with the plain one.

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
    # D = 96 (Phi-3-mini): one row, the borders of 64-row warpgroups and of
    # 128- and 192-row q tiles, groups of 2 and 4 over a kv_valid tail one
    # past a key tile, one valid key, fewer key tiles than ring stages, a
    # ragged tail, and kv_valid 1025 (the widest key tiles)
    (1, 2, 2, 1, 96, True, None), (2, 4, 2, 65, 96, True, None),
    (1, 8, 2, 191, 96, True, None), (1, 4, 4, 193, 96, True, None),
    (1, 4, 2, 136, 96, False, 129), (1, 8, 2, 136, 96, False, 129),
    (1, 2, 2, 300, 96, False, 1), (1, 4, 4, 40, 96, True, None),
    (2, 4, 4, 200, 96, False, 150), (1, 2, 2, 1032, 96, False, 1025),
    # causal borders of the q tiles aligned to the end of the sequence (the
    # ragged tile, S mod 192 or 128 rows, at its start): Qwen2's 14 / 2 heads
    # and G = 1 at D = 64, one row to 2113; D = 128 at 129 and 2113 rows;
    # D = 96 at 193
    *[(1, hq, hkv, s, 64, True, None) for hq, hkv in ((14, 2), (4, 4))
      for s in (1, 63, 65, 191, 193, 385, 2113)],
    (1, 16, 8, 129, 128, True, None), (1, 16, 8, 2113, 128, True, None),
    (1, 8, 8, 193, 96, True, None),
]
# the 2B ViT and LLM, InternViT-6B, internlm2-chat-20b (InternVL2-26B) and
# Phi-3-mini (InternVL2-4B) scoring 4 videos and training on 2
TIMED = {
    "vit_2b": (32, 16, 16, 1032, 64, False, 1025),
    "llm_2b": (4, 16, 8, 2113, 128, True, None),
    "vit_6b": (32, 25, 25, 1032, 128, False, 1025),
    "llm_20b": (4, 48, 8, 2113, 128, True, None),
    "llm_4b": (4, 32, 32, 2113, 96, True, None),
    "llm_4b_train": (2, 32, 32, 2113, 96, True, None),
    # Qwen2-0.5B (InternVL2-1B), 14 / 2 heads of 64
    "llm_1b": (4, 14, 2, 2113, 64, True, None),
    "llm_1b_train": (2, 14, 2, 2113, 64, True, None),
}
WITH_LSE = {"llm_4b_train", "llm_1b_train"}


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


def bit_equal(got: dict, label, shape) -> None:
    """Prints whether each other version's (out, lse) equal the tree's."""
    tree_out, tree_lse = got["tree"]
    print(json.dumps({"bit_equal": label, "dims": shape, "to_tree": {
        name: {"out": torch.equal(out, tree_out), "lse": torch.equal(lse, tree_lse)}
        for name, (out, lse) in got.items() if name != "tree"}}), flush=True)


def main(argv=None) -> int:
    from aigv_assessor_torch.ops import cuda_build
    from aigv_assessor_torch.ops import flash_attention as fa
    from aigv_assessor_torch.tools.decode_attention_ab import same_sass

    if not torch.cuda.is_available():
        print("attention_ab needs a CUDA card", file=sys.stderr)
        return 1
    args = list(argv if argv is not None else sys.argv[1:])
    check_only = "--check-only" in args
    args = [a for a in args if a != "--check-only"]
    timed = {} if check_only else dict(TIMED)
    if "--shapes" in args:
        at = args.index("--shapes")
        names = args[at + 1].split(",")
        del args[at : at + 2]
        unknown = sorted(set(names) - set(TIMED))
        if unknown:
            print(f"unknown shapes {unknown}; known: {sorted(TIMED)}", file=sys.stderr)
            return 2
        timed = {} if check_only else {n: TIMED[n] for n in names}
    device = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    versions = {"tree": fa.LIB}
    for arg in args:
        name, _, folder = arg.partition("=")
        lib = cuda_build.CudaLibrary("flash_attn_fwd.cu", fa._declare)
        lib.source = (Path(folder) / "flash_attn_fwd.cu").resolve()
        lib.path = cuda_build.BUILD_DIR / f"libflash_attn_fwd_{name}.so"
        versions[name] = lib
    for lib in versions.values():
        lib.path.unlink(missing_ok=True)
    cuda_build.build(list(versions.values()), verbose=True)

    ok = True
    for shape in CHECKS:
        _, hq, hkv, _, _, causal, kv_valid = shape
        qkv = make_qkv(shape, device)
        want, want_lse = fa.plain_attention_qkv(qkv, hq, hkv, causal=causal,
                                                kv_valid=kv_valid, return_lse=True)
        got = {}
        for name, lib in versions.items():
            fa.LIB = lib
            out, lse = fa.flash_attention_qkv_lse(qkv, hq, hkv, causal=causal, kv_valid=kv_valid)
            got[name] = out, lse
            err = (out.float() - want.float()).abs().max().item()
            lse_err = (lse - want_lse).abs().max().item()
            good = (torch.allclose(out.float(), want.float(), atol=TOL, rtol=TOL)
                    and lse_err <= LSE_TOL)
            ok &= good
            print(f"{name} {shape}: max_abs_err {err:.3e}, lse {lse_err:.3e} "
                  f"{'ok' if good else 'FAILED'}", flush=True)
        if len(versions) > 1:
            bit_equal(got, "check", shape)
    order = list(versions) + list(versions)[::-1]
    for label, shape in timed.items():
        _, hq, hkv, _, _, causal, kv_valid = shape
        qkv = make_qkv(shape, device)
        if len(versions) > 1:
            got = {}
            for name, lib in versions.items():
                fa.LIB = lib
                got[name] = fa.flash_attention_qkv_lse(qkv, hq, hkv, causal=causal,
                                                       kv_valid=kv_valid)
            bit_equal(got, label, shape)
            del got
        fwd = fa.flash_attention_qkv_lse if label in WITH_LSE else fa.flash_attention_qkv
        runs = {}
        for name in order:
            fa.LIB = versions[name]
            runs.setdefault(name, []).append(graph_ms(
                lambda: fwd(qkv, hq, hkv, causal=causal, kv_valid=kv_valid)))
        q, k, v = qkv[:, :hq], qkv[:, hq : hq + hkv, :kv_valid], qkv[:, hq + hkv :, :kv_valid]
        with torch.no_grad():
            sdpa_ms = graph_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                q, k, v, is_causal=causal, enable_gqa=hq != hkv))
        bound = flops(shape) / PEAK_FLOPS * 1e3
        print(json.dumps({"shape": label, "dims": shape, "lse": label in WITH_LSE,
                          "ms": runs, "sdpa_ms": sdpa_ms,
                          "bound_ms": bound,
                          "bound_share": {n: bound / min(t) for n, t in runs.items()},
                          "card": card}), flush=True)
        del qkv
    for name, lib in versions.items():
        if name != "tree":
            print(json.dumps({"sass_in_tree": name, "kernels": same_sass(
                versions["tree"].path, lib.path)}), flush=True)
    fa.LIB = versions["tree"]
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
