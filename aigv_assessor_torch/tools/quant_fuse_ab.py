"""The fused quantize feeds (K4a-c, K5a, K5b: `quant_rows_kernel`) of this
checkout against other versions of their source, on one CUDA card, in one
process.

    python -m aigv_assessor_torch.tools.quant_fuse_ab [--check-only] [--allow-unequal NAME] \\
        [--changed PRODUCER] [NAME=DIR ...]

Each DIR holds another `quant_fuse.cu`, e.g. the parent commit's
`aigv_assessor_torch/csrc` unpacked with `git archive`. Every version, the
checkout's own ("tree") first, is built with nvcc (`-Xptxas -v`) and, at
every FEEDS shape (the 2B ViT's and decoder's feeds, a ragged row count, the
8B decoder's SwiGLU width):
- held against the plain version: scales within SCALE_RTOL, int8 values at
  most one apart and at most FLIP_FRACTION of them apart, the flipped share
  printed;
- held bit for bit against the tree's q and s, except a producer named
  with `--changed` (whose math the tree changed) and a version named with
  `--allow-unequal` (a diagnostic): those only print whether they are equal;
- held bit for bit against the exact answer on `tie_grid`'s rows, where
  every y / s of every producer is a half-integer or an integer.
SASS per version (`cuobjdump -sass`): the instructions of the GELU and
identity instantiations at 4096 columns, and how many run on the quarter-
rate pipes (MUFU, conversions). A version with `aigv_gelu_values`: its GELU
producer against the exact function (float64) over every finite bf16 input:
the largest error in fp32 ulps where |y| >= 1e-3, the largest absolute
error below. Then each shape timed by CUDA graph replay
(GRAPH_CALLS launches a graph), the versions in turns (tree, others, others
reversed, tree), beside the byte bound. Prints the card's name and power
limit, then one JSON line per shape. Exits 1 if a check fails. Needs a CUDA
card; there is no CPU mode.
"""

from __future__ import annotations

import ctypes
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

SCALE_RTOL = 1e-5  # as chip_smoke.py
FLIP_FRACTION = 1e-3
PEAK_BYTES = 3.35e12
GRAPH_CALLS = 10
# (producer, rows, cols): the 2B ViT's feeds (32 frames x 1032 tokens), the
# identity producer also at the GELU's width (the bytes and the structure
# without GELU's math), the decoder's (4 videos x 2113 tokens) and the 8B
# decoder's SwiGLU width
FEEDS = {
    "ln_quant": ("layernorm", 33024, 1024),
    "gelu_quant": ("gelu", 33024, 4096),
    "ident_quant": ("identity", 33024, 1024),
    "ident_quant_4096": ("identity", 33024, 4096),
    "ident_quant_wo": ("identity", 8452, 2048),
    "rmsnorm_quant": ("rmsnorm", 8452, 2048),
    "silu_mul_quant": ("silu_mul", 8452, 8192),
    "silu_mul_quant_8b": ("silu_mul", 8452, 14336),
}
RAGGED_ROWS = 1000
PRODUCERS = ("identity", "layernorm", "gelu", "rmsnorm", "silu_mul")


def graph_ms(fns, iters: int = 20) -> float:
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


def feed_args(producer: str, rows: int, cols: int, gen: torch.Generator) -> tuple:
    """(x, extra tensors, eps) of one feed, drawn as chip_smoke.py draws them."""
    dev = gen.device
    x = (2.0 * torch.randn((rows, cols), generator=gen, device=dev)).to(torch.bfloat16)
    if producer == "silu_mul":
        return x, ((2.0 * torch.randn((rows, cols), generator=gen, device=dev))
                   .to(torch.bfloat16),), 0.0
    if producer not in ("layernorm", "rmsnorm"):
        return x, (), 0.0
    w = (1.0 + 0.2 * torch.randn(cols, generator=gen, device=dev)).to(torch.bfloat16)
    if producer == "rmsnorm":
        return x, (w,), 1e-5
    b = (0.1 * torch.randn(cols, generator=gen, device=dev)).to(torch.bfloat16)
    return x, (w, b), 1e-6


def tie_grid(producer: str, device, rows: int = 64, seed: int = 0):
    """Rows on which `producer` computes y exactly and every y / s is a
    half-integer k + 1/2 (-127 <= k <= 126) or +-127: -> (x, extra tensors,
    eps, q int8, s fp32 [rows, 1]), q and s the exact answer, rint half to
    even. A row holds shuffled copies of a block of 256 values, 16 copies
    (4096 columns), 2 for the norms (512, so that every partial sum of
    squares stays exact in fp32):
    - identity: x = v / 16, v the odd integers -253..253 and +-254, so
      s = 1/8 and y / s = v / 2;
    - LayerNorm, RMSNorm: x = v with gamma 1 (beta 0): the mean is 0 and the
      mean square is 5591302 / 256, so eps = 65536 - 5591302 / 256 (exact in
      fp32) makes the (r)sqrt 1/256 exactly, y = v / 256 and s = 1/128;
    - GELU: x = v / 16 for odd v >= 89 (tanh is 1.0 in fp32 from x = 5.5, so
      y = x), their negatives (y = -0) and 254 / 16, zeros besides;
    - silu-mul: x = 32 (sigmoid 1.0 in fp32), x2 = v / 512, y = v / 16."""
    rng = np.random.default_rng(seed)
    block = np.concatenate([np.arange(-253, 254, 2, dtype=np.float64), [254.0, -254.0]])
    if producer == "gelu":
        pos = np.arange(89, 254, 2, dtype=np.float64)
        block = np.concatenate([pos, -pos, [254.0], np.zeros(256 - 2 * len(pos) - 1)])
    norm = producer in ("layernorm", "rmsnorm")
    reps = 2 if norm else 16
    v = np.stack([np.concatenate([rng.permutation(block) for _ in range(reps)])
                  for _ in range(rows)])
    extra, eps = (), 0.0
    if producer == "identity":
        x, y, s = v / 16, v / 16, 1 / 8
    elif producer == "gelu":
        x, y, s = v / 16, np.where(v > 0, v / 16, 0.0), 1 / 8
    elif producer == "silu_mul":
        x, y, s = np.full_like(v, 32.0), v / 16, 1 / 8
        extra = (torch.tensor(v / 512, dtype=torch.bfloat16, device=device),)
    else:
        x, y, s = v, v / 256, 1 / 128
        mean = np.float32(float((block**2).sum()) / 256)
        eps = float(np.float32(65536) - mean)
        assert np.float32(mean + np.float32(eps)) == 65536
        ones = torch.ones(v.shape[1], dtype=torch.bfloat16, device=device)
        extra = (ones, torch.zeros_like(ones)) if producer == "layernorm" else (ones,)
    q = np.clip(np.rint(y / s), -127, 127)
    return (torch.tensor(x, dtype=torch.bfloat16, device=device), extra, eps,
            torch.tensor(q, dtype=torch.int8, device=device),
            torch.full((rows, 1), s, dtype=torch.float32, device=device))


def sass_counts(lib_path: Path) -> dict:
    """Instructions of the GELU and identity instantiations at 4096 columns
    (128 threads, 4 vectors of 8 a thread): all, and those of the quarter-rate
    pipes (MUFU, F2I / I2F / F2F / FRND)."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    try:
        text = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True, text=True,
                              check=True, timeout=120).stdout
    except (OSError, subprocess.SubprocessError) as err:
        return {"error": str(err)}
    out = {}
    for label, producer in (("gelu", 2), ("identity", 0)):
        key = f"quant_rows_kernelILi128ELi4ELi{producer}E"
        match = re.search(r"Function : (\S*" + key + r"\S*)\n(.*?)(?=\n\s*Function : |\Z)", text,
                          re.S)
        if not match:
            out[label] = None
            continue
        ops = re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)",
                         match.group(2))
        slow = [o for o in ops if o.split(".")[0] in ("MUFU", "F2I", "I2F", "F2F", "FRND")]
        out[label] = {"instructions": len(ops), "per_element": len(ops) / 32,
                      "quarter_rate": len(slow), "quarter_rate_ops": sorted(set(slow))}
    return out


def gelu_ulps(lib: ctypes.CDLL, device) -> dict:
    """The GELU producer against float64 over every finite bf16 input -> the
    largest error in ulps of the fp32 result, overall and where |y| >= 1e-3."""
    bits = torch.arange(0, 1 << 16, dtype=torch.int32).to(torch.int16)
    x = bits.view(torch.bfloat16)
    x = x[torch.isfinite(x)].to(device)
    y = torch.empty(x.shape, dtype=torch.float32, device=device)
    rc = lib.aigv_gelu_values(x.data_ptr(), y.data_ptr(), x.numel(),
                              torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(lib.aigv_cuda_error_string(rc).decode())
    xd = x.double().cpu().numpy()
    exact = 0.5 * xd * (1 + np.tanh(np.sqrt(2 / np.pi) * (xd + 0.044715 * xd**3)))
    got = y.cpu().numpy().astype(np.float64)
    ulp = np.spacing(np.abs(exact).astype(np.float32)).astype(np.float64)
    err = np.abs(got - exact) / ulp
    big = np.abs(exact) >= 1e-3
    worst = int(np.argmax(err[big]))
    return {"inputs": int(x.numel()), "max_ulp_where_y_ge_1e-3": float(err[big].max()),
            "at_x": float(xd[big][worst]), "max_abs_err": float(np.abs(got - exact).max()),
            "max_abs_err_where_y_lt_1e-3": float(np.abs(got - exact)[~big].max())}


def main(argv=None) -> int:
    from aigv_assessor_torch.ops import cuda_build
    from aigv_assessor_torch.ops import quant_fuse as qf

    if not torch.cuda.is_available():
        print("quant_fuse_ab needs a CUDA card", file=sys.stderr)
        return 1
    args = list(sys.argv[1:] if argv is None else argv)
    check_only = "--check-only" in args
    options = ("--allow-unequal", "--changed")
    unequal_ok = {args[i + 1] for i, a in enumerate(args) if a == "--allow-unequal"}
    changed = {args[i + 1] for i, a in enumerate(args) if a == "--changed"}
    args = [a for i, a in enumerate(args) if a != "--check-only" and a not in options
            and (i == 0 or args[i - 1] not in options)]
    device = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)

    def declare(lib):
        # an earlier source has the rows entry only
        lib.aigv_quant_rows_fwd.argtypes = [
            ctypes.c_int, *[ctypes.c_void_p] * 4, ctypes.c_float, *[ctypes.c_void_p] * 2,
            ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
        lib.aigv_quant_rows_fwd.restype = ctypes.c_int
        if hasattr(lib, "aigv_gelu_values"):
            lib.aigv_gelu_values.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                             ctypes.c_longlong, ctypes.c_void_p]
            lib.aigv_gelu_values.restype = ctypes.c_int

    versions = {"tree": qf.LIB}
    for arg in args:
        name, _, folder = arg.partition("=")
        lib = cuda_build.CudaLibrary("quant_fuse.cu", declare)
        lib.source = (Path(folder) / "quant_fuse.cu").resolve()
        lib.path = cuda_build.BUILD_DIR / f"libquant_fuse_{name}.so"
        versions[name] = lib
    for lib in versions.values():
        lib.path.unlink(missing_ok=True)
    cuda_build.build(list(versions.values()), verbose=True)
    ids = {"identity": qf._IDENTITY, "layernorm": qf._LAYERNORM, "gelu": qf._GELU_TANH,
           "rmsnorm": qf._RMSNORM, "silu_mul": qf._SILU_MUL}
    plains = {"identity": lambda x: qf.plain_quant_rows(x),
              "layernorm": lambda x, w, b: qf.plain_layernorm_quant(x, w, b, 1e-6),
              "gelu": lambda x: qf.plain_gelu_quant(x),
              "rmsnorm": lambda x, w: qf.plain_rmsnorm_quant(x, w, 1e-5),
              "silu_mul": lambda x, h3: qf.plain_silu_mul_quant(x, h3)}

    def run(name, producer, x, extra, eps):
        qf.LIB = versions[name]
        if producer == "silu_mul":
            return qf._launch(ids[producer], x, x2=extra[0])
        return qf._launch(ids[producer], x, *extra, eps=eps)

    ok = True
    for name, lib in versions.items():
        info = {"sass": sass_counts(lib.path)}
        handle = lib.load()
        if hasattr(handle, "aigv_gelu_values"):
            info["gelu_ulps"] = gelu_ulps(handle, device)
        print(json.dumps({"version": name, **info}), flush=True)
        for producer in PRODUCERS:
            x, extra, eps, q_want, s_want = tie_grid(producer, device)
            q, s = run(name, producer, x, extra, eps)
            torch.cuda.synchronize()
            exact = torch.equal(q, q_want) and torch.equal(s, s_want)
            ok &= exact
            print(f"{name} tie grid {producer}: {'bit-equal to rint(y / s)' if exact else 'FAILED'}"
                  f" ({int((q != q_want).sum())} int8 values differ)", flush=True)

    gen = torch.Generator(device=device)
    shapes = [(label, producer, r, cols) for label, (producer, rows, cols) in FEEDS.items()
              for r in (rows, RAGGED_ROWS)]
    for label, producer, rows, cols in shapes:
        gen.manual_seed(1)
        x, extra, eps = feed_args(producer, rows, cols, gen)
        q_p, s_p = plains[producer](x, *extra)
        results = {}
        ref = None
        for name in versions:
            q, s = run(name, producer, x, extra, eps)
            torch.cuda.synchronize()
            diff = (q.int() - q_p.int()).abs()
            flips = (diff > 0).float().mean().item()
            scale_err = ((s - s_p).abs() / s_p.abs()).max().item()
            good = scale_err <= SCALE_RTOL and diff.max().item() <= 1 and flips <= FLIP_FRACTION
            if ref is None:
                ref = (q, s)
            equal = torch.equal(q, ref[0]) and torch.equal(s, ref[1])
            ok &= good and (equal or name in unequal_ok or producer in changed)
            results[name] = dict(flipped_share=flips, scale_rel_err=scale_err,
                                 bit_equal_to_tree=equal, ok=good)
        line = {"shape": label, "rows": rows, "cols": cols, "checks": results}
        if not check_only and rows != RAGGED_ROWS:
            inputs = 2 if producer == "silu_mul" else 1
            vectors = {"layernorm": 2, "rmsnorm": 1}.get(producer, 0)
            nbytes = rows * cols * (2 * inputs + 1) + rows * 4 + 2 * vectors * cols
            bound = nbytes / PEAK_BYTES * 1e3
            runs = {}
            for name in list(versions) + list(versions)[::-1]:
                runs.setdefault(name, []).append(graph_ms(
                    [lambda n=name: run(n, producer, x, extra, eps)] * GRAPH_CALLS))
            line.update(ms=runs, bound_ms=bound,
                        bound_share={k: bound / min(v) for k, v in runs.items()})
        print(json.dumps({**line, "card": card}), flush=True)
        del x, extra, q_p, s_p, ref
    qf.LIB = versions["tree"]
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
