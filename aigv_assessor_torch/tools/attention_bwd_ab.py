"""The flash-attention backward of this checkout against other versions of
its source, on one CUDA card, in one process.

    python -m aigv_assessor_torch.tools.attention_bwd_ab [--check-only] [--shapes A,B]
        [NAME=DIR ...]

Each DIR holds another `flash_attn_bwd.cu` (and the headers it includes),
e.g. the parent commit's `aigv_assessor_torch/csrc` unpacked with `git
archive`. A source is called through the entry points it declares: this
checkout's one entry per caller form (`aigv_flash_attn_qkv_bwd`,
`aigv_flash_attn_bwd`: the delta launch and the kernel that writes dq, dk and
dv), or the earlier pair (`..._bwd_dq`, whose dq kernel takes `out` and
writes delta, and `..._bwd_dkv`), whose two calls are timed one by one and
summed. Every version, the checkout's own ("tree") first, is built with
nvcc (`-Xptxas -v`: registers and spills are printed) and held against the
plain backward at small shapes that cross its tiles' borders (q tiles of 64
/ 128 / 192 rows, key tiles of 64 and 128 keys, Skv = 127 / 129 / 257,
kv_valid 1025 of 1032), at D = 64, 96 and 128: dq, dk and dv within BWD_TOL
relative L2 of `plain_attention_qkv_bwd` / `plain_flash_attention_bwd`, dk
and dv of the keys at or beyond kv_valid exactly 0, delta within DELTA_TOL
relative L2 of the fp32 expression, and a second run bit-equal to the first.
Then each of the training paths' shapes (those named by `--shapes`, else
all) is timed by CUDA graph replay (3 launches per graph), the versions in
turns (tree, others, others reversed, tree), beside SDPA's backward alone on
the same views (`torch.autograd.grad` of one forward, kept; timed call by
call with CUDA events, since autograd does not run under graph capture).
Prints the card's name and power limit, then per shape a JSON line: ms per
call of each entry and their sum for each run, the share of the bound
(FLOPs / 989 TFLOP/s) on the products each version runs (the pair: 3 + 4,
the one kernel: 5) and on the 5 that any backward runs, SDPA's ms; and a
`bit_equal` line: whether each version's gradients from the replays equal
its eager run, and the other versions' the tree's. Last, for each DIR that
also holds a `flash_attn_fwd.cu`, a `sass_in_tree` line: which of its
forward kernels compile to the same SASS as the tree's. Exits 1 if a version
disagrees with the plain one.

Needs a CUDA card; there is no CPU mode.
"""

from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

import torch

BWD_TOL = 2e-3  # as chip_smoke.py: relative L2 of dq, dk, dv each
ZERO_GRAD_ATOL = 1e-3  # dq and dk where every row has one valid key
DELTA_TOL = 1e-5  # delta against (dout.float() * out.float()).sum(-1)
PEAK_FLOPS = 989e12

# (form, B, Sq, Skv, hq, hkv, D, causal, kv_valid, layout): "qkv" the fused
# head-major array (K3a / K3b), "sep" three tensors (K2's backward)
CHECKS = [
    ("qkv", 2, 1, 1, 16, 8, 128, True, None, "bhsd"),
    ("qkv", 2, 63, 63, 4, 4, 64, False, None, "bhsd"),
    ("qkv", 2, 65, 65, 4, 2, 128, True, None, "bhsd"),
    ("qkv", 1, 129, 129, 8, 2, 128, True, None, "bhsd"),
    ("qkv", 2, 193, 193, 4, 4, 64, False, 129, "bhsd"),
    ("qkv", 1, 191, 191, 8, 2, 64, True, None, "bhsd"),
    ("qkv", 1, 257, 257, 12, 2, 128, True, None, "bhsd"),
    ("qkv", 2, 257, 257, 4, 4, 64, False, 1, "bhsd"),
    ("qkv", 2, 300, 300, 5, 5, 128, False, 65, "bhsd"),
    ("qkv", 2, 200, 200, 4, 4, 64, False, 150, "bhsd"),
    ("sep", 2, 300, 129, 4, 2, 64, False, 100, "bshd"),
    ("sep", 2, 127, 257, 12, 2, 128, False, None, "bhsd"),
    ("sep", 2, 129, 129, 5, 5, 128, False, 1, "bshd"),
    ("sep", 3, 1, 129, 4, 2, 128, False, 100, "bshd"),
    ("sep", 2, 333, 1025, 8, 2, 128, False, 1000, "bhsd"),
    ("sep", 2, 200, 200, 4, 2, 128, True, None, "bshd"),
    # D = 96 (Phi-3-mini): causal across the q and key tiles with groups of 2
    # and 4, a ragged kv_valid one past a key tile, three tensors across
    ("qkv", 2, 65, 65, 4, 2, 96, True, None, "bhsd"),
    ("qkv", 1, 191, 191, 8, 2, 96, True, None, "bhsd"),
    ("qkv", 1, 257, 257, 8, 2, 96, True, None, "bhsd"),
    ("qkv", 1, 257, 257, 4, 2, 96, True, None, "bhsd"),
    ("qkv", 2, 193, 193, 4, 4, 96, False, 129, "bhsd"),
    ("sep", 2, 127, 257, 12, 2, 96, False, None, "bshd"),
    ("sep", 2, 200, 200, 4, 2, 96, True, None, "bshd"),
    # the one kernel's 128-key tiles: Skv one short of, one past and one past
    # two tiles, the ViT's kv_valid 1025 of 1032 at D = 64 and 128, causal
    # 14 / 2 heads of 64 (Qwen2-0.5B) at S = 193
    ("sep", 2, 100, 127, 4, 2, 64, False, None, "bshd"),
    ("sep", 2, 100, 129, 4, 2, 128, False, None, "bhsd"),
    ("qkv", 1, 257, 257, 4, 4, 128, False, None, "bhsd"),
    ("qkv", 2, 1032, 1032, 2, 2, 64, False, 1025, "bhsd"),
    ("sep", 2, 1032, 1032, 2, 2, 128, False, 1025, "bshd"),
    ("qkv", 1, 193, 193, 14, 2, 64, True, None, "bhsd"),
]
# the training paths' shapes: the 2B ViT and LLM, internlm2-chat-20b
# (InternVL2-26B's decoder, 2 videos), InternViT-6B over 32 frames and over a
# 26B micro-batch's 16, the 2B decoder's row-major branch, Phi-3-mini
# (InternVL2-4B's decoder, 2 videos)
TIMED = {
    "vit_2b": ("qkv", 32, 1032, 1032, 16, 16, 64, False, 1025, "bhsd"),
    "llm_2b": ("qkv", 4, 2113, 2113, 16, 8, 128, True, None, "bhsd"),
    "llm_20b": ("qkv", 2, 2113, 2113, 48, 8, 128, True, None, "bhsd"),
    "vit_6b": ("sep", 32, 1032, 1032, 25, 25, 128, False, 1025, "bshd"),
    "vit_6b_b16": ("sep", 16, 1032, 1032, 25, 25, 128, False, 1025, "bshd"),
    "llm_2b_rows": ("sep", 4, 2113, 2113, 16, 8, 128, True, None, "bshd"),
    "llm_4b": ("qkv", 2, 2113, 2113, 32, 32, 96, True, None, "bhsd"),
}


def declare_pair(lib: ctypes.CDLL) -> None:
    """The earlier pair of entries per caller form: dq (takes out, writes
    delta), then dk/dv (reads delta)."""
    for fn in (lib.aigv_flash_attn_qkv_bwd_dq, lib.aigv_flash_attn_qkv_bwd_dkv):
        fn.argtypes = [*[ctypes.c_void_p] * 6, *[ctypes.c_int] * 7,
                       ctypes.POINTER(ctypes.c_longlong), ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    for fn in (lib.aigv_flash_attn_bwd_dq, lib.aigv_flash_attn_bwd_dkv):
        fn.argtypes = [*[ctypes.c_void_p] * 10, *[ctypes.c_int] * 8,
                       ctypes.POINTER(ctypes.c_longlong), ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int


def one_kernel(source: Path) -> bool:
    """Whether the source has one entry per caller form (this checkout's)."""
    return "int aigv_flash_attn_qkv_bwd(" in source.read_text()


def make_inputs(case, device, seed=0):
    """q, k, v (views as the callers hand them over), out, lse and dout."""
    from aigv_assessor_torch.ops import flash_attention as fa

    form, b, sq, skv, hq, hkv, d, causal, kv_valid, layout = case
    gen = torch.Generator(device=device).manual_seed(seed)
    if form == "qkv":
        qkv = torch.randn((b, hq + 2 * hkv, sq, d), generator=gen, device=device)
        if kv_valid is not None:  # a garbage tail: +-1e3 in k and v
            qkv[:, hq : hq + hkv, kv_valid:] = 1e3
            qkv[:, hq + hkv :, kv_valid:] = -1e3
        qkv = qkv.to(torch.bfloat16)
        out, lse = fa.flash_attention_qkv_lse(qkv, hq, hkv, causal=causal, kv_valid=kv_valid)
        tensors = dict(qkv=qkv)
    else:
        if sq == skv:  # views of one row-major projection output
            proj = torch.randn((b, sq, (hq + 2 * hkv) * d), generator=gen, device=device)
            if kv_valid is not None:
                proj[:, kv_valid:, hq * d :] = 1e3
            proj = proj.to(torch.bfloat16)
            q = proj[..., : hq * d].view(b, sq, hq, d)
            k = proj[..., hq * d : (hq + hkv) * d].view(b, sq, hkv, d)
            v = proj[..., (hq + hkv) * d :].view(b, sq, hkv, d)
            if layout == "bhsd":
                q, k, v = (t.transpose(1, 2) for t in (q, k, v))
        else:
            q = torch.randn((b, hq, sq, d), generator=gen, device=device)
            k, v = (torch.randn((b, hkv, skv, d), generator=gen, device=device) for _ in "kv")
            if kv_valid is not None:
                k[:, :, kv_valid:], v[:, :, kv_valid:] = 1e3, -1e3
            q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
            if layout == "bshd":
                q, k, v = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        kw = dict(causal=causal, layout=layout, kv_valid=kv_valid)
        out, lse = fa.flash_attention_lse(q, k, v, **kw)
        tensors = dict(q=q, k=k, v=v)
    dout = torch.randn(out.shape, generator=gen, device=device)
    if kv_valid is not None and sq == skv:  # the callers' pad query rows carry no gradient
        dout.narrow(2 if layout == "bhsd" else 1, kv_valid, sq - kv_valid).zero_()
    return dict(tensors, out=out, lse=lse, dout=dout.to(torch.bfloat16))


class Version:
    """One build of a `flash_attn_bwd.cu` and how to call it."""

    def __init__(self, name: str, lib, single: bool):
        self.name, self.lib, self.single = name, lib, single

    def calls(self, case, x):
        """-> (grads, {entry: call}); the calls, in order, write into the
        tensors `grads` holds."""
        from aigv_assessor_torch.ops import flash_attention as fa

        form, b, sq, skv, hq, hkv, d, causal, kv_valid, layout = case
        kv = kv_valid or skv
        dev = x["out"].device
        delta = torch.empty((b, hq, sq), dtype=torch.float32, device=dev)
        if self.single:
            fa.LIB_BWD = self.lib
            if form == "qkv":
                qkv = x["qkv"]
                dqkv = torch.empty_like(qkv)
                return dict(dqkv=dqkv, delta=delta), {
                    "bwd": lambda: fa.flash_attention_qkv_bwd_kernel(
                        qkv, x["out"], x["dout"], x["lse"], delta, dqkv, hq, hkv, causal=causal,
                        kv_valid=kv_valid)}
            q, k, v = x["q"], x["k"], x["v"]
            dq, dk, dv = (torch.empty(t.shape, dtype=t.dtype, device=dev) for t in (q, k, v))
            return dict(dq=dq, dk=dk, dv=dv, delta=delta), {
                "bwd": lambda: fa.flash_attention_bwd_kernel(
                    q, k, v, x["out"], x["dout"], x["lse"], delta, dq, dk, dv, causal=causal,
                    layout=layout, kv_valid=kv_valid)}
        lib = self.lib.load()
        out, dout = x["out"], x["dout"]

        def stream():  # at call time, so that a graph capture records the launch
            return torch.cuda.current_stream(dev).cuda_stream

        if form == "qkv":
            qkv = x["qkv"]
            dqkv = torch.empty_like(qkv)
            strides = (ctypes.c_longlong * 12)(*qkv.stride()[:3], *out.stride()[:3],
                                                *dout.stride()[:3], *dqkv.stride()[:3])
            args = [qkv.data_ptr(), out.data_ptr(), dout.data_ptr(), x["lse"].data_ptr(),
                    delta.data_ptr(), dqkv.data_ptr(), b, hq, hkv, sq, d, kv, int(causal),
                    strides, d**-0.5]
            return dict(dqkv=dqkv, delta=delta), {
                "dq": lambda: check(lib.aigv_flash_attn_qkv_bwd_dq(*args, stream())),
                "dkv": lambda: check(lib.aigv_flash_attn_qkv_bwd_dkv(*args, stream()))}
        q, k, v = x["q"], x["k"], x["v"]
        dq, dk, dv = (torch.empty(t.shape, dtype=t.dtype, device=dev) for t in (q, k, v))
        seq, head = (2, 1) if layout == "bhsd" else (1, 2)
        strides = (ctypes.c_longlong * 24)(*[t.stride(i) for t in (q, k, v, out, dout, dq, dk, dv)
                                            for i in (0, head, seq)])
        ptrs = [t.data_ptr() for t in (q, k, v, out, dout, x["lse"], delta, dq, dk, dv)]
        tail = [b, hq, hkv, sq, skv, d, kv, int(causal), strides, d**-0.5]
        return dict(dq=dq, dk=dk, dv=dv, delta=delta), {
            "dq": lambda: check(lib.aigv_flash_attn_bwd_dq(*ptrs, *tail, stream())),
            "dkv": lambda: check(lib.aigv_flash_attn_bwd_dkv(*ptrs, *tail, stream()))}


def check(rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"backward launch failed with CUDA error {rc}")


def run(version: Version, case, x) -> dict:
    grads, calls = version.calls(case, x)
    for call in calls.values():
        call()
    torch.cuda.synchronize()
    return grads


def relative_l2(x, y) -> float:
    return ((x.float() - y.float()).norm() / y.float().norm().clamp_min(1e-30)).item()


def check_case(version: Version, case, device) -> tuple:
    """-> (ok, text) of one version at one CHECKS shape."""
    from aigv_assessor_torch.ops import flash_attention as fa

    form, b, sq, skv, hq, hkv, d, causal, kv_valid, layout = case
    x = make_inputs(case, device, seed=1)
    first, second = run(version, case, x), run(version, case, x)
    same = all(torch.equal(first[n], second[n]) for n in first)
    if form == "qkv":
        want = fa.plain_attention_qkv_bwd(x["qkv"], x["out"], x["lse"], x["dout"], hq, hkv,
                                          causal=causal, kv_valid=kv_valid)
        dqkv = first["dqkv"]
        got = {"dq": dqkv[:, :hq], "dk": dqkv[:, hq : hq + hkv], "dv": dqkv[:, hq + hkv :]}
        want = {"dq": want[:, :hq], "dk": want[:, hq : hq + hkv], "dv": want[:, hq + hkv :]}
        seq = 2
    else:
        w = fa.plain_flash_attention_bwd(x["q"], x["k"], x["v"], x["out"], x["lse"], x["dout"],
                                         causal=causal, layout=layout, kv_valid=kv_valid)
        got = {n: first[n] for n in ("dq", "dk", "dv")}
        want = dict(zip(("dq", "dk", "dv"), w))
        seq = 2 if layout == "bhsd" else 1
    rel = {n: relative_l2(got[n], want[n]) for n in got}
    finite = all(torch.isfinite(t).all() for t in got.values())
    one_key = min(skv, kv_valid or skv) == 1
    if one_key:  # dq and dk are 0 in exact arithmetic: held to 0
        zero = max(got["dq"].abs().max().item(), got["dk"].abs().max().item())
        good = zero <= ZERO_GRAD_ATOL and rel["dv"] <= BWD_TOL
    else:
        good = all(r <= BWD_TOL for r in rel.values())
    masked_zero = kv_valid is None or not (
        got["dk"].narrow(seq, kv_valid, skv - kv_valid).any()
        or got["dv"].narrow(seq, kv_valid, skv - kv_valid).any())
    hm = (lambda t: t) if form == "qkv" or layout == "bhsd" else (lambda t: t.transpose(1, 2))
    want_delta = hm((x["dout"].float() * x["out"].float()).sum(-1))
    delta_rel = relative_l2(first["delta"], want_delta)
    ok = finite and good and masked_zero and same and delta_rel <= DELTA_TOL
    text = (f"{version.name} {case}: rel L2 " + " ".join(f"{n} {r:.3e}" for n, r in rel.items())
            + f", delta {delta_rel:.3e}, masked keys 0: {masked_zero}, bit-equal runs: {same} "
            f"{'ok' if ok else 'FAILED'}")
    return ok, text


def graph_ms(fn, iters: int = 10) -> float:
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


def flops(case) -> dict:
    """FLOPs by products per (query, key) pair and head-dim element: the
    pair's dq kernel 3 and dk/dv kernel 4, the one kernel 5 (what any
    backward runs)."""
    _, b, sq, skv, hq, _, d, causal, kv_valid, _ = case
    pairs = sq * (sq + 1) // 2 if causal else sq * (kv_valid or skv)
    per = 2.0 * b * hq * pairs * d
    return {"dq": 3 * per, "dkv": 4 * per, "bwd": 5 * per}


def grads_equal(a: dict, b: dict) -> bool:
    return all(torch.equal(a[n], b[n]) for n in a)


def sdpa_bwd_ms(case, x) -> float:
    """SDPA's backward alone on head-major views, k and v cut at kv_valid."""
    form, b, sq, skv, hq, hkv, d, causal, kv_valid, layout = case
    kv = kv_valid or skv
    if form == "qkv":
        qkv = x["qkv"]
        q, k, v = qkv[:, :hq], qkv[:, hq : hq + hkv, :kv], qkv[:, hq + hkv :, :kv]
        dout = x["dout"]
    else:
        hm = (lambda t: t) if layout == "bhsd" else (lambda t: t.transpose(1, 2))
        q, k, v = hm(x["q"]), hm(x["k"])[:, :, :kv], hm(x["v"])[:, :, :kv]
        dout = hm(x["dout"])
    q, k, v = (t.detach().requires_grad_() for t in (q, k, v))
    out = torch.nn.functional.scaled_dot_product_attention(
        q, k, v, is_causal=causal, enable_gqa=hq != hkv)
    # autograd does not run under graph capture: CUDA events around 10 calls
    for _ in range(3):
        torch.autograd.grad(out, (q, k, v), dout, retain_graph=True)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(10):
        torch.autograd.grad(out, (q, k, v), dout, retain_graph=True)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / 10


def main(argv=None) -> int:
    from aigv_assessor_torch.ops import cuda_build
    from aigv_assessor_torch.ops import flash_attention as fa
    from aigv_assessor_torch.tools.decode_attention_ab import same_sass

    if not torch.cuda.is_available():
        print("attention_bwd_ab needs a CUDA card", file=sys.stderr)
        return 1
    args = list(argv if argv is not None else sys.argv[1:])
    check_only = "--check-only" in args
    args = [a for a in args if a != "--check-only"]
    timed = dict(TIMED)
    if "--shapes" in args:
        at = args.index("--shapes")
        names = args[at + 1].split(",")
        del args[at : at + 2]
        unknown = sorted(set(names) - set(TIMED))
        if unknown:
            print(f"unknown shapes {unknown}; known: {sorted(TIMED)}", file=sys.stderr)
            return 2
        timed = {n: TIMED[n] for n in names}
    device = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    tree_lib = fa.LIB_BWD
    versions = {"tree": Version("tree", tree_lib, True)}
    forwards = {}
    for arg in args:
        name, _, folder = arg.partition("=")
        source = (Path(folder) / "flash_attn_bwd.cu").resolve()
        single = one_kernel(source)
        lib = cuda_build.CudaLibrary("flash_attn_bwd.cu",
                                     fa._declare_bwd if single else declare_pair)
        lib.source = source
        lib.path = cuda_build.BUILD_DIR / f"libflash_attn_bwd_{name}.so"
        versions[name] = Version(name, lib, single)
        fwd = Path(folder) / "flash_attn_fwd.cu"
        if fwd.exists():
            flib = cuda_build.CudaLibrary("flash_attn_fwd.cu", fa._declare)
            flib.source = fwd.resolve()
            flib.path = cuda_build.BUILD_DIR / f"libflash_attn_fwd_{name}.so"
            forwards[name] = flib
    libs = [fa.LIB, *(v.lib for v in versions.values()), *forwards.values()]
    for lib in libs[1:]:
        lib.path.unlink(missing_ok=True)
    cuda_build.build(libs, verbose=True)

    ok = True
    try:
        for version in versions.values():
            for case in CHECKS:
                good, text = check_case(version, case, device)
                ok &= good
                print(text, flush=True)
        if check_only:
            return 0 if ok else 1
        order = list(versions) + list(versions)[::-1]
        for label, case in timed.items():
            x = make_inputs(case, device)
            runs, eager, replayed = {}, {}, {}
            for name in order:
                grads, calls = versions[name].calls(case, x)
                t = {entry: graph_ms(call) for entry, call in calls.items()}
                t["sum"] = sum(t.values())
                runs.setdefault(name, []).append(t)
                replayed.setdefault(name, {n: g.clone() for n, g in grads.items()})
            for name in versions:
                eager[name] = run(versions[name], case, x)
            sdpa = sdpa_bwd_ms(case, x)
            bound = {n: f / PEAK_FLOPS * 1e3 for n, f in flops(case).items()}
            best = {name: {k: min(r[k] for r in rs) for k in rs[0]} for name, rs in runs.items()}
            print(json.dumps({
                "shape": label, "dims": case, "ms": runs, "sdpa_bwd_ms": sdpa,
                "bound_ms": bound,
                "bound_share": {n: {k: bound[k] / v for k, v in b.items() if k in bound}
                                for n, b in best.items()},
                "bound_share_5_products": {n: bound["bwd"] / b["sum"] for n, b in best.items()},
                "vs_sdpa_bwd": {n: b["sum"] / sdpa for n, b in best.items()},
                "card": card}), flush=True)
            print(json.dumps({
                "bit_equal": label,
                "replay_to_eager": {n: grads_equal(replayed[n], eager[n]) for n in versions},
                "to_tree": {n: grads_equal({k: v for k, v in eager[n].items() if k != "delta"},
                                           {k: eager["tree"][k] for k in eager[n] if k != "delta"})
                            for n in versions if n != "tree"}}), flush=True)
            del x, eager, replayed
            torch.cuda.empty_cache()
        for name, flib in forwards.items():
            print(json.dumps({"sass_in_tree": name, "forward": same_sass(fa.LIB.path, flib.path)}),
                  flush=True)
    finally:
        fa.LIB_BWD = tree_lib
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
