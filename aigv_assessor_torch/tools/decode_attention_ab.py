"""The decode attention (K8) of this checkout against other versions of its
source, on one CUDA card, in one process.

    python -m aigv_assessor_torch.tools.decode_attention_ab [--check-only] [--shapes A,B]
        [--repeat N] [NAME=DIR ...]

Each DIR holds another `decode_attention.cu`, e.g. the parent commit's
`aigv_assessor_torch/csrc` unpacked with `git archive`. A source is called
through the entry it declares: this checkout's `aigv_cached_decode_attention`
(one launch, the current token merged in or not; its last argument, the
form, is ignored by an earlier source of the same entry, which takes one
argument fewer), or the earlier two-kernel `aigv_decode_attention` (window
only, fp32 partial states in scratch; its "fused" form is that launch plus
the eager `merge_new_token`). Every version, the checkout's own ("tree")
first, is built with nvcc (`-Xptxas -v`: registers and spills are printed)
and held against the plain versions at CHECKS, with NaN in every cache row
outside the windows: the window's out within DECODE_TOL of
`plain_decode_attention` and m, l within ML_RTOL; the fused form within
DECODE_TOL of `plain_cached_decode_attention`; a second run bit-equal to the
first; the tree's fused launch captured in a CUDA graph and replayed three
times, bit-equal to the eager one. CHECKS hold the 2B decoder's shapes
(G = 2, D = 128, also at B = 16: 128 (kv head, sample) pairs), Phi-3-mini's
(G = 1, D = 96, whole and ragged windows), Qwen2-0.5B's (14 / 2 heads of 64)
and the borders of the tiles, the pieces and the group sizes.

Then, at the decode step's shapes (TIMED: `path`, `ragged`, `batch1_long`,
the path's cache stored head-major, `end_zero`, `phi3`, `qwen2`,
`path_b16`; `--shapes` picks some), over DECODE_LAYERS cache layers that
together exceed the 50 MB L2 (a decoder walking its layers finds them
cold), by CUDA graph replay, the versions in turns (tree, others, others
reversed, tree; `--repeat N` rounds of them): the window alone and the
fused form, and SDPA with a one-token query (its mask where the windows are
ragged) in every turn; the eager `merge_new_token`; the window of each
version with the fused entry at each split count of SPLITS (the tree's in
the split form, and at one piece in the wide form too); and call by call,
host included, each version's fused form and SDPA; where every window
starts at the same row, each version's window and SDPA on the windows cut
to FRACTIONS of their rows, fitted to us = fixed + bytes / rate. Prints the
card's name and power limit, then one JSON line per shape: us per call of
each run, the byte bound (the windows' K and V rows, q read and out written
once, at 3.35 TB/s), each run's share of it, the fit, the tree's split
count and form. Last, for each other version, which of its kernels compile
to the same SASS in the tree (`cuobjdump -sass`, addresses, encodings and
labels aside). Exits 1 if a version disagrees with the plain one. Needs a
CUDA card; there is no CPU mode.
"""

from __future__ import annotations

import ctypes
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import torch

DECODE_TOL = 2e-2  # as chip_smoke.py: bf16 out, atol = rtol
ML_RTOL = 1e-4
PEAK_BYTES = 3.35e12
DECODE_LAYERS = 6
# (B, hq, hkv, D, max_len, end, starts)
CHECKS = {
    "path": (4, 16, 8, 128, 2177, 2113, (0, 0, 0, 0)),
    "phi3": (4, 32, 32, 96, 2177, 2145, (0, 0, 0, 0)),
    "qwen2": (4, 14, 2, 64, 2177, 2145, (0, 3, 0, 40)),
    "path_b16": (16, 16, 8, 128, 2177, 2113, (0,) * 16),
    # G = 1 at D = 96, ragged: one window ends inside a tile, one holds one
    # row, one is empty
    "phi3_ragged": (4, 32, 32, 96, 2177, 2150, (0, 701, 2149, 2150)),
    "ragged": (4, 16, 8, 128, 2177, 2150, (0, 500, 1500, 2100)),
    "end_zero": (4, 16, 8, 128, 2177, 0, (0, 0, 0, 0)),
    "one_row": (4, 16, 8, 128, 2177, 2113, (2112, 2112, 0, 2112)),
    "d64": (4, 16, 16, 64, 1100, 1025, (0, 0, 3, 1000)),
    "empty_and_one_row": (3, 16, 8, 128, 300, 200, (200, 199, 150)),
    "group8_d64": (2, 16, 2, 64, 500, 499, (3, 0)),
    "group4_d128": (1, 8, 2, 128, 70, 70, (0,)),
    "group3_d64": (2, 9, 3, 64, 200, 150, (0, 20)),
    "batch1_long": (1, 16, 8, 128, 4096, 4000, (5,)),
}
# the last two: the path's cache stored head-major (each head's rows
# contiguous, read through the same strided view), and no row at all (the
# launch's fixed cost)
TIMED = ("path", "ragged", "batch1_long", "path_headmajor", "end_zero", "phi3", "qwen2",
         "path_b16")
SPLITS = (1, 2, 4, 5, 6, 7, 8, 10, 12, 16)
FRACTIONS = (1 / 128, 0.25, 0.5, 1.0)  # of the windows' rows: the fixed cost, the rate


def graph_us(fns, iters: int = 20) -> float:
    """Device us per call of `fns`, captured into one CUDA graph and replayed."""
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
    return start.elapsed_time(end) / iters / len(fns) * 1e3


def call_us(fns, iters: int = 20) -> float:
    """us per call of `fns` made one by one: the host's cost where it exceeds
    the device's."""
    for fn in fns:
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        for fn in fns:
            fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters / len(fns) * 1e3


def sass_bodies(lib_path: Path) -> dict:
    """Each kernel's SASS in `cuobjdump -sass`, by mangled name, as a tuple of
    instructions without addresses and encodings, labels numbered from 0 in
    the function."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True, text=True,
                          check=True, timeout=120).stdout
    bodies = {}
    for name, body in re.findall(r"Function : (\S+)\n(.*?)(?=\n\s*Function : |\Z)", text, re.S):
        labels: dict = {}
        instr = []
        for line in body.splitlines():
            op = re.search(r"/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;", line)
            if op:
                instr.append(re.sub(r"\.L_x_\d+",
                                    lambda m: labels.setdefault(m.group(0), f"L{len(labels)}"),
                                    op.group(1)))
        bodies[name] = tuple(instr)
    return bodies


def same_sass(tree: Path, other: Path) -> dict:
    """For each kernel of `other`: the tree's kernel with the same
    instructions, or None; {"error": ...} without a working cuobjdump."""
    try:
        mine = {body: name for name, body in sass_bodies(tree).items()}
        return {name: mine.get(body) for name, body in sass_bodies(other).items()}
    except (OSError, subprocess.SubprocessError) as err:
        return {"error": str(err)}


def _declare_old(lib: ctypes.CDLL) -> None:
    lib.aigv_decode_attention.argtypes = [
        *[ctypes.c_void_p] * 11, *[ctypes.c_int] * 6, *[ctypes.c_longlong] * 8,
        ctypes.c_float, ctypes.c_void_p]
    lib.aigv_decode_attention.restype = ctypes.c_int


def old_window(lib, q, ck, cv, starts, end):
    """The two-kernel source's window -> (out, m, l), as its wrapper called it."""
    b, hq, d = q.shape
    _, max_len, hkv, _ = ck.shape
    nsplit = max(1, min(-(-176 // (b * hkv)), max_len // 64, 32))
    out = torch.empty((b, hq, d), dtype=q.dtype, device=q.device)
    ml = torch.empty((2, b, hq), dtype=torch.float32, device=q.device)
    slots = b * hq * nsplit
    scratch = torch.empty(slots * (d + 2), dtype=torch.float32, device=q.device)
    part, m_ptr = scratch.data_ptr(), ml.data_ptr()
    rc = lib.aigv_decode_attention(
        q.data_ptr(), ck.data_ptr(), cv.data_ptr(), starts.data_ptr(), end.data_ptr(), part,
        part + 4 * slots * d, part + 4 * slots * (d + 1), out.data_ptr(), m_ptr,
        m_ptr + 4 * b * hq, b, hq, hkv, max_len, d, nsplit, q.stride(0), q.stride(1),
        *ck.stride()[:3], *cv.stride()[:3], d**-0.5, torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"old decode attention: {lib.aigv_cuda_error_string(rc).decode()}")
    return out, ml[0], ml[1]


def main(argv=None) -> int:
    from aigv_assessor_torch.ops import cuda_build
    from aigv_assessor_torch.ops import decode_attention as dec

    if not torch.cuda.is_available():
        print("decode_attention_ab needs a CUDA card", file=sys.stderr)
        return 1
    args = list(sys.argv[1:] if argv is None else argv)
    check_only = "--check-only" in args
    args = [a for a in args if a != "--check-only"]
    timed, repeat = TIMED, 1
    if "--shapes" in args:  # a comma-separated subset of TIMED
        at = args.index("--shapes")
        timed = tuple(args[at + 1].split(","))
        del args[at : at + 2]
    if "--repeat" in args:  # rounds of turns
        at = args.index("--repeat")
        repeat = int(args[at + 1])
        del args[at : at + 2]
    device = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)

    versions = {"tree": dec.LIB}
    for arg in args:
        name, _, folder = arg.partition("=")
        lib = cuda_build.CudaLibrary("decode_attention.cu", dec._declare)
        lib.source = (Path(folder) / "decode_attention.cu").resolve()
        lib.path = cuda_build.BUILD_DIR / f"libdecode_attention_{name}.so"
        versions[name] = lib
    for lib in versions.values():
        lib.path.unlink(missing_ok=True)
    cuda_build.build(list(versions.values()), verbose=True)
    fused_entry = {}
    for name, lib in versions.items():
        fused_entry[name] = hasattr(ctypes.CDLL(str(lib.path)), "aigv_cached_decode_attention")
        if not fused_entry[name]:
            lib._declare = _declare_old

    def window(name, q, ck, cv, starts, end, nsplit=None, wide=None):
        if fused_entry[name]:
            dec.LIB = versions[name]
            return dec._launch(q, ck, cv, starts, end, nsplit=nsplit, wide=wide)
        return old_window(versions[name].load(), q, ck, cv, starts, end)

    def fused(name, q, ck, cv, starts, end, kn, vn):
        if fused_entry[name]:
            dec.LIB = versions[name]
            return dec._launch(q, ck, cv, starts, end, kn, vn)
        out, m, l = old_window(versions[name].load(), q, ck, cv, starts, end)
        return dec.merge_new_token(out, m, l, q, kn[:, None], vn[:, None])

    def inputs(case, head_major=False):
        b, hq, hkv, d, max_len, end_i, starts_t = case
        gen = torch.Generator(device=device).manual_seed(5)
        q = torch.randn((b, hq, d), generator=gen, device=device).to(torch.bfloat16)
        if head_major:
            stack = torch.randn((2, DECODE_LAYERS, b, hkv, max_len, d), generator=gen,
                                device=device).to(torch.bfloat16).transpose(3, 4)
        else:
            stack = torch.randn((2, DECODE_LAYERS, b, max_len, hkv, d), generator=gen,
                                device=device).to(torch.bfloat16)
        # the current token as the decoder hands it over: views of one row
        new = torch.randn((b, 2, hkv, d), generator=gen, device=device).to(torch.bfloat16)
        starts = torch.tensor(starts_t, dtype=torch.int32, device=device)
        end = torch.tensor(end_i, dtype=torch.int32, device=device)
        return q, stack, new[:, 0], new[:, 1], starts, end

    ok = True
    for label, case in CHECKS.items():
        q, stack, kn, vn, starts, end = inputs(case)
        ck, cv = stack[0, 1], stack[1, 1]
        rows = torch.arange(ck.shape[1], device=device)
        inside = (rows[None] >= starts[:, None]) & (rows[None] < end)
        ck_nan, cv_nan = ck.clone(), cv.clone()
        ck_nan[~inside] = float("nan")
        cv_nan[~inside] = float("nan")
        w_out, w_m, w_l = dec.plain_decode_attention(q, ck, cv, starts, end)
        w_fused = dec.plain_cached_decode_attention(q[:, None], kn[:, None], vn[:, None], ck, cv,
                                                    end, starts=starts)[:, 0]
        for name in versions:
            out, m, l = window(name, q, ck_nan, cv_nan, starts, end)
            out2, _, _ = window(name, q, ck_nan, cv_nan, starts, end)
            got = fused(name, q, ck_nan, cv_nan, starts, end, kn, vn)
            got2 = fused(name, q, ck_nan, cv_nan, starts, end, kn, vn)
            torch.cuda.synchronize()
            errs = dict(
                out=(out.float() - w_out.float()).abs().max().item(),
                m=((m - w_m).abs() / w_m.abs().clamp_min(1e-6)).max().item(),
                l=((l - w_l).abs() / w_l.abs().clamp_min(1e-6)).max().item(),
                fused=(got.float() - w_fused.float()).abs().max().item())
            good = (all(torch.isfinite(t).all() for t in (out, m, l, got))
                    and torch.allclose(out.float(), w_out.float(), atol=DECODE_TOL,
                                       rtol=DECODE_TOL)
                    and torch.allclose(m, w_m, atol=1e-5, rtol=ML_RTOL)
                    and torch.allclose(l, w_l, atol=1e-6, rtol=ML_RTOL)
                    and torch.allclose(got.float(), w_fused.float(), atol=DECODE_TOL,
                                       rtol=DECODE_TOL)
                    and torch.equal(out, out2) and torch.equal(got, got2))
            if name == "tree":
                graph = torch.cuda.CUDAGraph()
                with torch.cuda.graph(graph):
                    replayed = fused(name, q, ck_nan, cv_nan, starts, end, kn, vn)
                for _ in range(3):
                    graph.replay()
                    torch.cuda.synchronize()
                    good &= torch.equal(replayed, got)
                del graph
            ok &= good
            print(f"{name} {label} {case}: max abs err out {errs['out']:.3e}, fused "
                  f"{errs['fused']:.3e}; m / l max rel err {errs['m']:.2e} / {errs['l']:.2e} "
                  f"{'ok' if good else 'FAILED'}", flush=True)
        del stack, ck_nan, cv_nan
    if check_only:
        dec.LIB = versions["tree"]
        return 0 if ok else 1

    order = (list(versions) + list(versions)[::-1]) * repeat
    for label in timed:
        case = CHECKS[label.replace("_headmajor", "")]
        b, hq, hkv, d, max_len, end_i, starts_t = case
        q, stack, kn, vn, starts, end = inputs(case, head_major=label.endswith("_headmajor"))
        layers = [(stack[0, i], stack[1, i]) for i in range(DECODE_LAYERS)]
        n_rows = sum(max(end_i - s, 0) for s in starts_t)
        nbytes = n_rows * hkv * d * 2 * 2 + 2 * b * hq * d * 2
        bound = nbytes / PEAK_BYTES * 1e6

        def each(fn):
            return [lambda lk=lk, lv=lv: fn(lk, lv) for lk, lv in layers]

        qs = q[:, :, None]
        rows = torch.arange(max_len, device=device)
        inside = (rows[None] >= starts[:, None]) & (rows[None] < end)
        mask = None if not any(starts_t) else inside[:, None, None, :end_i]

        def sdpa(lk, lv):
            return torch.nn.functional.scaled_dot_product_attention(
                qs, lk[:, :end_i].transpose(1, 2), lv[:, :end_i].transpose(1, 2),
                attn_mask=mask, enable_gqa=hq != hkv)
        runs, calls = {}, {}
        for name in order:  # SDPA in every turn too
            runs.setdefault(f"{name}/window", []).append(graph_us(each(
                lambda lk, lv, n=name: window(n, q, lk, lv, starts, end))))
            runs.setdefault(f"{name}/fused", []).append(graph_us(each(
                lambda lk, lv, n=name: fused(n, q, lk, lv, starts, end, kn, vn))))
            calls.setdefault(f"{name}/fused", []).append(call_us(each(
                lambda lk, lv, n=name: fused(n, q, lk, lv, starts, end, kn, vn))))
            runs.setdefault("sdpa", []).append(graph_us(each(sdpa)))
        calls["sdpa"] = [call_us(each(sdpa))]
        for name in (n for n in versions if fused_entry[n]):
            for ns in SPLITS:
                runs[f"{name}/window/nsplit={ns}"] = [graph_us(each(
                    lambda lk, lv, n=name: window(n, q, lk, lv, starts, end, nsplit=ns,
                                                  wide=False)))]
            runs[f"{name}/window/nsplit=1/wide"] = [graph_us(each(
                lambda lk, lv, n=name: window(n, q, lk, lv, starts, end, nsplit=1, wide=True)))]
        out, m, l = window("tree", q, *layers[0], starts, end)
        runs["merge_new_token"] = [graph_us([lambda: dec.merge_new_token(
            out, m, l, q, kn[:, None], vn[:, None])] * DECODE_LAYERS)]
        calls["merge_new_token"] = [call_us([lambda: dec.merge_new_token(
            out, m, l, q, kn[:, None], vn[:, None])] * DECODE_LAYERS)]
        fit = {}
        if n_rows and len(set(starts_t)) == 1:
            # the same windows cut to FRACTIONS of their rows (from the end):
            # us = fixed + bytes / rate, least squares, for each version's
            # window and for SDPA on the same rows
            points = {}
            for frac in FRACTIONS:
                lo = end_i - int((end_i - starts_t[0]) * frac)
                cut = torch.full_like(starts, lo)
                nb = b * (end_i - lo) * hkv * d * 2 * 2
                for name in versions:
                    points.setdefault(name, []).append((nb, graph_us(each(
                        lambda lk, lv, n=name: window(n, q, lk, lv, cut, end)))))
                points.setdefault("sdpa", []).append((nb, graph_us(each(
                    lambda lk, lv, lo=lo: torch.nn.functional.scaled_dot_product_attention(
                        qs, lk[:, lo:end_i].transpose(1, 2), lv[:, lo:end_i].transpose(1, 2),
                        enable_gqa=hq != hkv)))))
            for name, pts in points.items():
                xs, ys = [x for x, _ in pts], [y for _, y in pts]
                mx, my = sum(xs) / len(xs), sum(ys) / len(ys)
                slope = (sum((x - mx) * (y - my) for x, y in pts)
                         / sum((x - mx) ** 2 for x in xs))
                fit[name] = {"fixed_us": my - slope * mx, "tb_s": 1e-6 / slope,
                             "us": ys}
        if nbytes > 2 * b * hq * d * 2:
            # a yardstick of the read rate: torch.amax over contiguous tensors
            # of the windows' bytes, as many as the cache has layers
            flats = [torch.ones(nbytes // 2, dtype=torch.bfloat16, device=device)
                     for _ in range(DECODE_LAYERS)]
            runs["amax_same_bytes"] = [graph_us([lambda f=f: f.amax() for f in flats])]
            del flats
        sms = dec._sm_count(device.index or 0)
        nsplit = dec._splits(b, hkv, max_len, sms)
        print(json.dumps({
            "shape": label, "case": case, "rows": n_rows, "bytes": nbytes, "bound_us": bound,
            "us": runs, "call_us": calls, "fit": fit, "nsplit_tree": nsplit,
            "wide_tree": dec._wide(b, hkv, nsplit, sms),
            "bound_share": {k: bound / min(v) for k, v in runs.items()}, "card": card}),
            flush=True)
        del stack, layers
    for name, lib in versions.items():
        if name != "tree":
            print(json.dumps({"sass_in_tree": name, "kernels": same_sass(
                versions["tree"].path, lib.path)}), flush=True)
    dec.LIB = versions["tree"]
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
