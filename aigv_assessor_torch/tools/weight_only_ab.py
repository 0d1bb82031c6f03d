"""The weight-only matmuls (K6 int8, K7 int4) and the fp8 decode matvec (K9)
of this checkout against other versions of their sources, on one CUDA card,
in one process.

    python -m aigv_assessor_torch.tools.weight_only_ab [--fp8-only] \\
        [--prefill-only] [--check-only] [--allow-unequal NAME] \\
        [--variant BASE.EDIT ...] [NAME=DIR ...]

Each DIR holds another `weight_only_matmul.cu` and `fp8_matmul.cu` (and the
headers they include), e.g. the parent commit's `aigv_assessor_torch/csrc`
unpacked with `git archive`. Every version, the checkout's own ("tree")
first, is built with nvcc (`-Xptxas -v`: registers and spills are printed,
and summed per kernel on a `registers` line; a spill in the tree's GEMM
kernel fails the run). A version whose library has the GEMM and GEMV
entries is run in each of its forms (`ops/int8_matmul._launch_form`); an
older one through its single entry, the name the unaligned form keeps; an
older `fp8_matmul.cu` through its single entry, whichever form the wrapper
picks. `--fp8-only` skips K6 / K7; `--prefill-only` times K6 / K7's GEMM
form alone (no decode rows, no threshold, no K9); `--check-only` times
nothing. `--allow-unequal NAME` marks a diagnostic version (e.g. one whose
products are skipped): its checks are printed and do not fail the run.

`--variant BASE.EDIT` builds a copy of version BASE's `weight_only_matmul.cu`
(BASE is "tree" or a NAME) with one of EDITS applied to its GEMM form, as
the version "BASE.EDIT": `products_only` (constant A fragments in place of
the ldmatrix, the shuffles and the decode: the products, the rings and the
epilogue), `decode_only` (no products: the rings, the decode and the
epilogue), `no_store` (constant fragments and no store of y: the products
and the rings): diagnostics that give wrong results and are timed at the 2B
shapes only.

Checks: every form of every version against `plain_int8_matmul` /
`plain_int4_matmul` in fp64 at small shapes that cross its borders
(relative L2 at most WO_TOL, an all-zero channel exactly 0), and the GEMM
form at GEMM_EDGES (tile counts around the SM count and its multiples, the
2B wo / w2's 544 tiles, a last m tile of 4 rows) with a second launch and a
CUDA graph replay bit-equal to the first. K9 against
`plain_fp8_matmul` (FP8_TOL) at FP8_CHECKS (M = 1..17, N below and across
the 16-channel tiles, K below one 64-byte step, off 16 bytes, tile counts on
both sides of each border where the plan changes), on a weight that holds
every finite e4m3 code, with an all-zero channel exactly 0; a second launch
and a CUDA graph replay bit-equal to the first launch (the tree: the wrapper
and both forms by name); and the in-kernel convert bit for bit: with x the
identity's rows and scale 1, y is the weight's columns as
`w8.to(bfloat16)` gives them, over every finite code.

Times, by CUDA graph replay, the versions in turns (tree, others, others
reversed, tree), with `F.linear` in bf16 on the dequantized weight in the
same process:
- M = 8452 at the 2B decoder's wqkv, wo, w1 (= w3) and w2, and at the
  decoder projections of InternVL2-26B, -4B and -1B (OTHER_PREFILL): each
  version's GEMM form or its single kernel, with a `bit_equal` map (each
  version's y against the tree's);
- M = 1, 4, 8 at the same projections, the fp8 probe's fused w13 (2048 ->
  16384) and the LM head (2048 -> 92553, M = 4): the GEMV form or the single
  kernel, cycling over weight copies that together exceed the 50 MB L2, as a
  decoder walking its layers finds them;
- the decode threshold: M = 4, 8, 16, 32, 64 at wqkv and w2, the tree's GEMV
  and GEMM forms over the same copies;
- K9 at the probe's three shapes and M = 1, 4, 8 and at FP8_RAGGED over
  copies beyond L2, and at FP8_FIXED (no weight to stream: the fixed cost of
  a launch): each version's wrapper, and the tree's two forms by name
  (`stream` where the rows start on 16 bytes), with the form the wrapper
  takes and the stream body's plan.

SASS per version (`cuobjdump -sass`): K9's E4M3 instantiations (the stream
and the tile body), each one's main loop (the backward branch that spans
the most HMMA) and the instructions a lane issues there per weight byte
(each HMMA takes 8 weight bytes of every lane), counted in the code, not as
executed; and a `sass_in_tree` line per other version: which of its K6 /
K7 kernels (the GEMV and unaligned forms' among them) compile to the same
SASS as one of the tree's.

Prints the card's name and power limit, then one JSON line per shape: ms per
call of each run, the bound (max of FLOPs / 989 TFLOP/s and bytes / 3.35
TB/s), TFLOP/s and `F.linear`'s ms. Exits 1 if a version disagrees with the
plain one. Needs a CUDA card; there is no CPU mode.
"""

from __future__ import annotations

import ctypes
import json
import re
import shutil
import subprocess
import sys
from collections import Counter
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
# (K, N) of the other decoders' projections at the same rows: InternVL2-26B
# (internlm2-chat-20b: 6144 wide, 48 / 8 heads of 128, 16384 MLP), -4B
# (Phi-3-mini: 3072, 32 / 32 heads of 96, fused gate_up of 2 x 8192), -1B
# (Qwen2-0.5B: 896, 14 / 2 heads of 64, 4864 MLP)
OTHER_PREFILL = {
    "26b_wqkv": (6144, 8192), "26b_wo": (6144, 6144), "26b_w1": (6144, 16384),
    "26b_w2": (16384, 6144),
    "4b_qkv": (3072, 9216), "4b_o": (3072, 3072), "4b_gate_up": (3072, 16384),
    "4b_down": (8192, 3072),
    "1b_wqkv": (896, 1152), "1b_wo": (896, 896), "1b_w1": (896, 4864), "1b_w2": (4864, 896)}
# (M, K, N) where the GEMM form's schedule changes on 132 SMs: tile counts
# (256 rows x 128 channels) of 131, 132, 133, 143, 263, 264, 265, 527, 528
# and 529, the 2B wo / w2's 544 (33 full m tiles and one of 4 rows), and a
# last m tile of 100 and of 200 rows
GEMM_EDGES = [(33536, 64, 128), (2816, 256, 1536), (34048, 64, 128), (2816, 256, 1537),
              (67328, 64, 128), (5632, 64, 1536), (13568, 64, 640), (7936, 64, 2176),
              (8448, 64, 2048), (5888, 64, 2944), (PREFILL_ROWS, 2048, 2048),
              (612, 256, 384), (456, 256, 384)]
DECODE = {**PROJECTIONS, "w13": (2048, 16384)}
DECODE_ROWS = (1, 4, 8)
# Edits of a `weight_only_matmul.cu` for `--variant`, applied to its GEMM form
# (the text from `namespace gemm {` on): groups of (pattern, replacement)
# alternatives, each group to match at least once. The patterns fit this
# checkout's source and the one before it.
CONSTANT_FRAGMENTS = (r"fragments<BITS>\(([^;]*?),\s*(\w+)\);",
                      r"for (int s_ = 0; s_ < 4; ++s_) for (int j_ = 0; j_ < 4; ++j_) "
                      r"\2[s_][j_] = 0x3F803F80u;")
EDITS = {
    "products_only": [[CONSTANT_FRAGMENTS]],
    # each fragment register summed into one accumulator, so that the decode
    # is not dead code
    "decode_only": [[(r"wgmma_rs_n(\d+)\(\s*acc\s*,\s*([^,]+?),[^;]*;",
                      r"acc[0] += __uint_as_float((\2)[0] ^ (\2)[1] ^ (\2)[2] ^ (\2)[3]);")]],
    # the stores behind a condition that never holds (M > 0), so that the
    # products are not dead code
    "no_store": [[CONSTANT_FRAGMENTS],
                 [(r"if \(ch(\d) < N\) dst\[ch\1\] = ", r"if (ch\1 < N && M < 0) dst[ch\1] = "),
                  (r"store_tile<", r"if (M < 0) store_tile<")]],
}
DIAGNOSTICS = ("products_only", "decode_only", "no_store")
LM_HEAD = (2048, 92553)
THRESHOLD_ROWS = (4, 8, 16, 32, 64)
FP8_SHAPES = {"wqkv": (2048, 4096), "w13": (2048, 16384), "w2": (8192, 2048)}
FP8_RAGGED = (3, 2050, 4100)  # (M, K, N): K off the 16-byte spans, N off the 16 channels
FP8_FIXED = (8, 64, 16)  # (M, K, N): one tile, one 64-byte step
# (M, K, N): one K step, ragged K steps (K = 160; K = 100 only unaligned), M
# across the GEMV blocks of 8 rows, the GEMV / GEMM threshold and the GEMM's
# 256-row tiles, N across the 16-channel blocks, the 64-channel consumer
# warpgroups and the 128-channel tiles, y's rows off 4 bytes
CHECKS = [(1, 64, 16), (8, 2048, 256), (9, 2048, 257), (16, 160, 255), (17, 64, 130),
          (64, 2048, 256), (65, 2048, 256), (127, 2048, 256), (128, 160, 512),
          (129, 2048, 384), (257, 2048, 129), (300, 2048, 511), (33, 100, 96)]
# K9's borders (M, K, N): N below, at and across one 16-channel tile; K below
# one 64-byte step, off 16 bytes, and K = 8192 + 64 (129 steps: neither split
# divides them); M = 1..9, 16, 17 (the 8-row blocks); tile counts around 66,
# 132 and 264, where the plan's split and streams change on 132 SMs
FP8_CHECKS = ([(m, 2048, 4096) for m in range(1, 10)]
              + [(1, 64, 16), (8, 64, 1), (3, 64, 15), (2, 64, 17), (1, 1, 16), (5, 17, 40),
                 (8, 63, 100), (4, 100, 257), (8, 2050, 4100), (16, 8256, 2048),
                 (17, 8256, 2064), (1, 8192, 2048)]
              + [(m, 8192, 16 * t) for m in (1, 8) for t in (33, 34, 65, 66, 67, 131, 132, 133,
                                                            263, 264, 265)])


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


def edited_source(base: Path, edit: str, out: Path) -> Path:
    """A copy of the directory `base` (a `weight_only_matmul.cu` and its
    headers) in `out`, with EDITS[edit] applied to its GEMM form."""
    out.mkdir(parents=True, exist_ok=True)
    for f in base.iterdir():
        if f.suffix in (".cu", ".cuh"):
            shutil.copy(f, out / f.name)
    text = (base / "weight_only_matmul.cu").read_text()
    at = text.index("namespace gemm {")
    head, body = text[:at], text[at:]
    for group in EDITS[edit]:
        hits = 0
        for pattern, repl in group:
            body, n = re.subn(pattern, repl, body, flags=re.S)
            hits += n
        if not hits:
            raise RuntimeError(f"--variant {edit}: no match for {group} in {base}")
    (out / "weight_only_matmul.cu").write_text(head + body)
    return out


def ptxas_summary(text: str) -> dict:
    """`nvcc -Xptxas -v` output (the `# libNAME.so` headers of
    `cuda_build.build`) -> {library: {kernel: registers, spill bytes,
    warnings}}, the K6 / K7 kernels only (`weight_only`, `decode_matvec`)."""
    out, lib, fn = {}, None, None
    for line in text.splitlines():
        if line.startswith("# lib"):
            lib, fn = line[2:].strip(), None
            out[lib] = {}
            continue
        loss = re.search(r"(?:Performance Loss|serialized).*'([\w$]+)'", line)
        if lib is not None and loss and re.search(r"weight_only|decode_matvec", loss.group(1)):
            out[lib].setdefault(loss.group(1), {"registers": None, "spill_bytes": 0,
                                                "warnings": []})["warnings"].append(line.strip())
            continue
        found = re.search(r"(?:Compiling entry function|Function properties for) '?([\w$]+)", line)
        if found:
            fn = found.group(1)
            continue
        if lib is None or fn is None or not re.search(r"weight_only|decode_matvec", fn):
            continue
        entry = out[lib].setdefault(fn, {"registers": None, "spill_bytes": 0, "warnings": []})
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if spill:
            entry["spill_bytes"] += int(spill.group(1)) + int(spill.group(2))
        regs = re.search(r"Used (\d+) registers", line)
        if regs:
            entry["registers"] = int(regs.group(1))
        if "warning" in line.lower():
            entry["warnings"].append(line.strip())
    return out


def sass_counts(lib_path: Path) -> dict:
    """K9's E4M3 instantiations in `cuobjdump -sass`, by body (`stream`,
    `tiles`; an older library's one kernel as `tiles`): all instructions,
    those of the main loop (the backward branch spanning the most HMMA), the
    loop's opcodes, and its instructions per weight byte of a lane."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    try:
        text = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True, text=True,
                              check=True, timeout=120).stdout
    except (OSError, subprocess.SubprocessError) as err:
        return {"error": str(err)}
    found = re.findall(r"Function : (\S*E4M3\S*)\n(.*?)(?=\n\s*Function : |\Z)", text, re.S)
    return {("stream" if "stream_kernel" in name else "tiles"): loop_counts(name, body)
            for name, body in found}


def loop_counts(name: str, body: str) -> dict:
    """One function's SASS listing -> its instruction count, and its main
    loop's: instructions, HMMA, opcodes, and instructions per weight byte."""
    instr, labels, pending = [], {}, []
    for line in body.splitlines():
        label = re.match(r"\s*(\.L_x_\d+):", line)
        if label:
            pending.append(label.group(1))
            continue
        op = re.search(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)(.*)", line)
        if not op:
            continue
        addr = int(op.group(1), 16)
        for label_name in pending:
            labels[label_name] = addr
        pending = []
        instr.append((addr, op.group(2), op.group(3)))
    loops = []
    for addr, op_name, rest in instr:
        if not op_name.startswith("BRA"):
            continue
        target = re.search(r"`\((\.L_x_\d+)\)|(0x[0-9a-f]+)", rest)
        if not target:
            continue
        to = labels.get(target.group(1)) if target.group(1) else int(target.group(2), 16)
        if to is not None and to < addr:
            loops.append([n for a, n, _ in instr if to <= a <= addr])
    out = {"function": name, "instructions": len(instr)}
    if loops:
        loop = max(loops, key=lambda b: (sum(n.startswith("HMMA") for n in b), len(b)))
        hmma = sum(n.startswith("HMMA") for n in loop)
        ops = Counter(n.split(".")[0] for n in loop)
        out.update(loop_instructions=len(loop), loop_hmma=hmma, loop_ops=dict(ops),
                   per_weight_byte=len(loop) / (8 * hmma) if hmma else None)
    return out


def exact_convert(f8, device, form=None):
    """(y, want): K9 with x the first 8 rows of the identity and scale 1 on a
    [256, 2048] weight whose first 8 columns hold every finite e4m3 code, so
    that y[m, n] = w8[n, m] as bf16 exactly (one nonzero product, summed and
    scaled exactly), and `w8.to(bfloat16)`'s columns."""
    codes = torch.tensor([c for c in range(256) if c not in (0x7F, 0xFF)], dtype=torch.uint8)
    n, k = 256, 2048
    idx = torch.arange(n)[:, None] + 7 * torch.arange(k)[None, :]
    w8 = codes[idx % codes.numel()].to(device).view(torch.float8_e4m3fn)
    x = torch.eye(8, k, device=device).to(torch.bfloat16)
    scale = torch.ones(n, device=device)
    y = f8.fp8_matmul(x, w8, scale) if form is None else f8._launch_form(form, x, w8, scale)
    return y, w8[:, :8].to(torch.bfloat16).t()


def main(argv=None) -> int:
    import contextlib
    import io

    from aigv_assessor_torch.ops import cuda_build
    from aigv_assessor_torch.ops import fp8_matmul as f8
    from aigv_assessor_torch.ops import int8_matmul as wo
    from aigv_assessor_torch.tools.decode_attention_ab import same_sass

    if not torch.cuda.is_available():
        print("weight_only_ab needs a CUDA card", file=sys.stderr)
        return 1
    args = list(argv if argv is not None else sys.argv[1:])
    flags = {a for a in args if a in ("--fp8-only", "--prefill-only", "--check-only", "--no-check")}
    fp8_only, prefill_only = "--fp8-only" in flags, "--prefill-only" in flags
    check_only, no_check = "--check-only" in flags, "--no-check" in flags
    valued = {"--allow-unequal": [], "--variant": [], "--shapes": []}
    rest = []
    it = iter(a for a in args if a not in flags)
    for a in it:
        if a in valued:
            valued[a].append(next(it))
        else:
            rest.append(a)
    unequal_ok = set(valued["--allow-unequal"])
    device = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)

    def declare_single(lib):
        f8._declare(lib, ("aigv_fp8_matmul",))
        for entry in f8._ENTRIES.values():
            setattr(lib, entry, lib.aigv_fp8_matmul)

    def library(source, declare, folder, name):
        lib = cuda_build.CudaLibrary(source, declare)
        lib.source = (Path(folder) / source).resolve()
        lib.path = cuda_build.BUILD_DIR / f"lib{Path(source).stem}_{name}.so"
        return lib

    versions = {"tree": (wo.LIB, f8.LIB)}
    folders = {"tree": cuda_build.CSRC}
    for arg in rest:
        name, _, folder = arg.partition("=")
        folders[name] = Path(folder)
        versions[name] = (library("weight_only_matmul.cu", wo._declare, folder, name),
                          library("fp8_matmul.cu", f8._declare, folder, name))
    diagnostic = set()
    for spec in valued["--variant"]:
        base, _, edit = spec.rpartition(".")
        if edit not in EDITS or base not in folders:
            raise SystemExit(f"--variant {spec}: BASE.EDIT with BASE in {list(folders)} and "
                             f"EDIT in {list(EDITS)}")
        folder = edited_source(folders[base], edit,
                               cuda_build.BUILD_DIR.parent / "variants" / spec)
        versions[spec] = (library("weight_only_matmul.cu", wo._declare, folder, spec),
                          versions[base][1])  # K9 as its base has it
        if edit in DIAGNOSTICS:
            diagnostic.add(spec)
            unequal_ok.add(spec)
    every = list(dict.fromkeys(lib for pair in versions.values()
                               for lib in pair[1 if fp8_only else 0:]))
    for lib in every:
        lib.path.unlink(missing_ok=True)
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        cuda_build.build(every, verbose=True)
    print(log.getvalue(), end="", flush=True)
    ok = True
    registers = ptxas_summary(log.getvalue())
    print(f"registers: {json.dumps(registers)}", flush=True)
    for kernel, entry in registers.get(wo.LIB.path.name, {}).items():
        if "gemm" in kernel and (entry["spill_bytes"] or entry["warnings"]):
            print(f"FAILED: the tree's GEMM kernel {kernel} spills or is serialized: {entry}")
            ok = False
    # the forms each version's library has; an older library has only the
    # entries the unaligned form keeps
    forms = {}
    for name, (wlib, flib) in versions.items():
        if not fp8_only:
            handle = ctypes.CDLL(str(wlib.path))
            forms[name] = [f for f in wo.FORMS if hasattr(handle, wo._ENTRIES[f].format(8))]
            wlib._declare = lambda lib, fs=tuple(forms[name]): wo._declare(lib, fs)
        if not hasattr(ctypes.CDLL(str(flib.path)), f8._ENTRIES["stream"]):
            flib._declare = declare_single  # an older version: one entry takes both forms
        if not prefill_only:
            print(f"{name} K9 SASS: {json.dumps(sass_counts(flib.path))}", flush=True)

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

    def fp8_plan(m, k, n):
        """The form the wrapper takes and the stream body's plan, or None for
        an older version."""
        if not hasattr(f8.LIB.load(), "aigv_fp8_matmul_plan"):
            return None
        x = torch.empty((m, k), dtype=torch.bfloat16, device=device)
        w8 = torch.empty((n, k), dtype=torch.uint8, device=device).view(torch.float8_e4m3fn)
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        return f8.fp8_form(m, k, n, x, w8, sms), f8.launch_plan(m, n, k)._asdict()

    def check(label, name, got, want, n):
        nonlocal ok
        rel = relative_l2(got, want)
        good = bool(torch.isfinite(got).all()) and rel <= WO_TOL and not got[:, n // 2].any()
        ok &= good or name in unequal_ok
        print(f"{label}: rel L2 {rel:.3e} {'ok' if good else 'FAILED'}", flush=True)
        return good

    # checks (a diagnostic version is only timed)
    for name in [v for v in versions if v not in diagnostic and not no_check]:
        use(name)
        for bits in () if fp8_only else (8, 4):
            plain = wo.plain_int8_matmul if bits == 8 else wo.plain_int4_matmul
            for m, k, n in CHECKS:
                x, q, s, _ = operands(bits, m, k, n)
                want = plain(x.double(), q, s, out_dtype=torch.float64)
                aligned = wo.weight_only_form(m, k, n, bits, x, q) != "unaligned"
                for form in [f for f in forms[name] if f != "gemm" or aligned]:
                    check(f"{name} int{bits} {form} M={m} K={k} N={n}", name,
                          run(form, bits, x, q, s), want, n)
            if "gemm" not in forms[name]:
                continue
            # the GEMM form where its schedule changes: against the plain
            # version, a second launch and a graph replay bit-equal
            for m, k, n in GEMM_EDGES:
                x, q, s, _ = operands(bits, m, k, n)
                got, again = run("gemm", bits, x, q, s), run("gemm", bits, x, q, s)
                static = torch.empty_like(got)
                graph = torch.cuda.CUDAGraph()
                with torch.cuda.graph(graph):
                    static.copy_(run("gemm", bits, x, q, s))
                graph.replay()
                torch.cuda.synchronize()
                same = torch.equal(got, again) and torch.equal(got, static)
                good = check(f"{name} int{bits} gemm edge M={m} K={k} N={n} "
                             f"({-(-m // 256) * -(-n // 128)} tiles), rerun and replay "
                             f"{'bit-equal' if same else 'DIFFER'}", name,
                             got, plain(x.double(), q, s, out_dtype=torch.float64), n)
                ok &= same or name in unequal_ok
                del x, q, s, got, again, static, graph
        if prefill_only:
            continue
        k9_ok = True
        for m, k, n in FP8_CHECKS:
            w = torch.randn((n, k), generator=gen, device=device) * 0.02
            w[n // 2] = 0.0
            w8, s8 = f8.quantize_weight_fp8(w)
            x = torch.randn((m, k), generator=gen, device=device).to(torch.bfloat16)
            want = f8.plain_fp8_matmul(x, w8, s8)
            aligned = k % 16 == 0
            for form in ("wrapper",) + (f8.FORMS if name == "tree" and aligned else ()):
                def call():
                    if form == "wrapper":
                        return f8.fp8_matmul(x, w8, s8)
                    return f8._launch_form(form, x, w8, s8)
                got, again = call(), call()
                torch.cuda.synchronize()
                rel = relative_l2(got, want)
                good = (bool(torch.isfinite(got).all()) and rel <= FP8_TOL
                        and not got[:, n // 2].any() and torch.equal(got, again))
                k9_ok &= good
                print(f"{name} fp8 {form} M={m} K={k} N={n} {fp8_plan(m, k, n)}: rel L2 "
                      f"{rel:.3e}{'' if good else ' FAILED'}", flush=True)
        # every finite e4m3 code in every channel, at random scales
        codes = torch.arange(256, dtype=torch.int32)
        codes = codes[(codes != 0x7F) & (codes != 0xFF)].to(torch.uint8)
        n, k = 272, 2048
        w8 = codes.to(device)[(torch.arange(n * k, device=device) * 7
                               + torch.arange(n * k, device=device) // k) % codes.numel()]
        w8 = w8.view(n, k).view(torch.float8_e4m3fn)
        s8 = torch.rand(n, generator=gen, device=device) * 1e-3 + 1e-4
        for m in (1, 8):
            x = torch.randn((m, k), generator=gen, device=device).to(torch.bfloat16)
            got = f8.fp8_matmul(x, w8, s8)
            rel = relative_l2(got, f8.plain_fp8_matmul(x, w8, s8))
            # a CUDA graph replay is bit-equal to the eager launch
            static = torch.empty_like(got)
            graph = torch.cuda.CUDAGraph()
            f8.fp8_matmul(x, w8, s8)
            torch.cuda.synchronize()
            with torch.cuda.graph(graph):
                static.copy_(f8.fp8_matmul(x, w8, s8))
            graph.replay()
            torch.cuda.synchronize()
            good = rel <= FP8_TOL and torch.equal(static, got)
            k9_ok &= good
            print(f"{name} fp8 every finite code M={m} K={k} N={n}: rel L2 {rel:.3e}, graph "
                  f"replay {'bit-equal' if torch.equal(static, got) else 'DIFFERS'}"
                  f"{'' if good else ' FAILED'}", flush=True)
        for form in (None,) + (f8.FORMS if name == "tree" else ()):
            good = bool(torch.equal(*exact_convert(f8, device, form)))
            k9_ok &= good
            print(f"{name} fp8 {form or 'wrapper'} convert of every finite code bit for bit: "
                  f"{'equal' if good else 'DIFFERS'}", flush=True)
        ok &= k9_ok or name in unequal_ok

    if not fp8_only:
        for name in versions:
            if name != "tree":
                print(f"sass_in_tree {name}: "
                      f"{json.dumps(same_sass(versions['tree'][0].path, versions[name][0].path))}",
                      flush=True)
    if check_only:
        use("tree")
        return 0 if ok else 1

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

    # prefill: the GEMM form (or an older version's single kernel), F.linear
    # in the middle of the turns
    prefill = {**PROJECTIONS, **OTHER_PREFILL}
    if valued["--shapes"]:  # a comma-separated subset
        prefill = {k: v for k, v in prefill.items() if k in valued["--shapes"][-1].split(",")}
    for bits in () if fp8_only else (8, 4):
        for label, (k, n) in prefill.items():
            x, q, s, deq = operands(bits, PREFILL_ROWS, k, n)
            runs, equal, ys = {}, {}, {}
            linear = None
            for i, name in enumerate(order):
                if i == len(versions):
                    linear = graph_ms([lambda: F.linear(x, deq)] * 3, 10)
                if name in diagnostic and label not in PROJECTIONS:
                    continue
                use(name)
                form = "gemm" if "gemm" in forms[name] else "unaligned"
                runs.setdefault(f"{name}/{form}", []).append(graph_ms(
                    [lambda f=form: run(f, bits, x, q, s)] * 3, 10))
                if name not in ys:
                    ys[name] = run(form, bits, x, q, s)
                    equal[name] = torch.equal(ys[name], ys["tree"])
            report(label, bits, PREFILL_ROWS, k, n, runs, linear, bit_equal=equal)
            del x, q, s, deq, ys
    if prefill_only:
        use("tree")
        return 0 if ok else 1

    # decode and the threshold: weight copies beyond the L2
    def cycled(fn, weights, iters=20):
        return graph_ms([lambda w=w: fn(w) for w in weights], iters)

    decode_cases = [(label, m, k, n) for label, (k, n) in DECODE.items() for m in DECODE_ROWS]
    decode_cases.append(("lm_head", 4, *LM_HEAD))
    threshold = [(label, m, *PROJECTIONS[label])
                 for label in ("wqkv", "w2") for m in THRESHOLD_ROWS]
    plain_versions = [name for name in order if name not in diagnostic]
    for bits in () if fp8_only else (8, 4):
        for kind, cases in (("decode", decode_cases), ("threshold", threshold)):
            for label, m, k, n in cases:
                x, q, s, deq = operands(bits, m, k, n)
                copies = int(2 * L2_BYTES // q.numel()) + 1
                qs = [q] + [q.clone() for _ in range(copies - 1)]
                runs = {}
                for name in plain_versions if kind == "decode" else ["tree", "tree"]:
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

    # K9: the probe's shapes, the ragged one and the fixed cost
    fp8_cases = [(label, m, k, n) for label, (k, n) in FP8_SHAPES.items() for m in DECODE_ROWS]
    fp8_cases += [("ragged", *FP8_RAGGED), ("fixed", *FP8_FIXED)]
    for label, m, k, n in fp8_cases:
        w = torch.randn((n, k), generator=gen, device=device) * 0.02
        w8, s8 = f8.quantize_weight_fp8(w)
        deq = f8.dequantize_weight_fp8(w8, s8, torch.bfloat16)
        copies = 1 if label == "fixed" else int(2 * L2_BYTES // w8.numel()) + 1
        ws = [w8] + [w8.clone() for _ in range(copies - 1)]
        x = torch.randn((m, k), generator=gen, device=device).to(torch.bfloat16)
        runs, plan = {}, {}
        calls = ws if copies > 1 else ws * 20
        for name in plain_versions:
            use(name)
            plan[name] = fp8_plan(m, k, n)
            runs.setdefault(f"{name}/fp8", []).append(
                cycled(lambda w_: f8.fp8_matmul(x, w_, s8), calls))
            if name == "tree":  # each body by name, where it takes the shape
                for form in f8.FORMS if k % 16 == 0 else ("tiles",):
                    runs.setdefault(f"tree/{form}", []).append(
                        cycled(lambda w_, f=form: f8._launch_form(f, x, w_, s8), calls))
        deqs = [deq] + [deq.clone() for _ in range(copies // 2)]
        linear = cycled(lambda w_: F.linear(x, w_), deqs if copies > 1 else deqs * 20)
        del deqs, ws
        b = max(2.0 * m * n * k / PEAK_FLOPS,
                (2 * m * k + n * k + 4 * n + 2 * m * n) / PEAK_BYTES) * 1e3
        print(json.dumps({"shape": f"fp8_{label}", "M": m, "K": k, "N": n, "ms": runs,
                          "linear_ms": linear, "bound_ms": b, "plan": plan,
                          "bound_share": {key: b / min(v) for key, v in runs.items()},
                          "weight_copies": copies, "card": card}), flush=True)
    use("tree")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
