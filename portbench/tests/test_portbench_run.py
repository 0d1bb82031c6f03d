"""Whole runs of the tiny cells on the CPU (the harness's look for a card
skipped), the result line, and what the runs may load."""

import ast
import functools
import json
import os
import shutil
import subprocess
import sys
from unittest import mock

import pytest
import torch

from conftest import ROOT
from portbench import harness, spec

SEED = 2**33 + 99  # more than 32 signed bits hold
TINY_CELLS = ["tiny-score", "tiny-qknorm-score", "tiny-serve"]
DEVICE_KEYS = {"platform", "kind", "count", "memory_peak_bytes"}


@pytest.mark.parametrize("cell", TINY_CELLS)
@pytest.mark.parametrize("traced", [False, True])
def test_tiny_cell_runs_correct(tiny_root, cell, traced):
    torch.set_num_threads(2)
    c = spec.load_cell(cell, tiny_root)
    out = harness.run_cell(c, SEED, 1.0, traced, "cpu")
    assert out["correct"] and out["failed"] == 0 and out["attempted"] > 0
    assert list(out)[-1] == "check"
    assert set(out["check"]) == set(c.limits)
    assert DEVICE_KEYS <= set(out["device"])
    metrics = c.per_layer if traced else c.end_to_end
    assert set(out["metrics"]) <= {m.name for m in metrics}
    if traced:
        assert {"busy_s", "window_s"} <= set(out["device"])
        assert all(len(v) <= 10 for v in out["breakdown"].values())
    else:
        assert "setup_s" in out["metrics"]
    json.dumps(out)


def test_main_prints_the_result_line_last(tiny_root, capsys):
    """`main` with a stand-in card: the check lines end standard error and
    the result is the last line of standard output."""
    real = harness.run_cell

    def on_cpu(cell, seed, seconds, trace, device, **kw):
        return real(cell, seed, seconds, trace, "cpu", **kw)

    with mock.patch.object(spec, "load_cell", functools.partial(spec.load_cell, root=tiny_root)), \
            mock.patch.object(torch.cuda, "is_available", return_value=True), \
            mock.patch.object(torch.cuda, "device_count", return_value=1), \
            mock.patch.object(harness, "build_kernels", return_value=0.0), \
            mock.patch.object(harness, "_card_line", return_value="a stand-in"), \
            mock.patch.object(harness, "run_cell", on_cpu):
        rc = harness.main(["--workload", "tiny-score", "--seed", str(SEED),
                           "--seconds", "1", "--trace", "0"])
    captured = capsys.readouterr()
    assert rc == 0
    line = json.loads(captured.out.strip().splitlines()[-1])
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(line)
    assert list(line)[-1] == "check" and line["correct"]
    err = captured.err.strip().splitlines()
    assert len(line["check"]) == sum(1 for e in err if e.startswith("check "))
    assert all(e.startswith("check ") for e in err[-len(line["check"]):])


def _python(code, cwd, pythonpath):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = os.pathsep.join(str(p) for p in pythonpath)
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=600)


def test_a_run_loads_no_jax(tiny_root):
    """A whole tiny run in a fresh process: no loaded module's top-level
    name is jax, jaxlib, flax or the JAX package (aigv_assessor_torch shares
    the JAX package's prefix, and must not count)."""
    code = (
        "import sys, torch; torch.set_num_threads(2)\n"
        "from portbench import harness, spec\n"
        f"out = harness.run_cell(spec.load_cell('tiny-score'), {SEED}, 0.5, False, 'cpu')\n"
        "assert out['correct'], out\n"
        "assert 'aigv_assessor_torch' in sys.modules\n"
        "print(harness.forbidden_modules())\n"
    )
    proc = _python(code, tiny_root, [tiny_root, ROOT])
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().splitlines()[-1] == "[]"


def test_forbidden_names_compare_whole_top_level_names():
    code = (
        "import sys, types\n"
        "from portbench import harness\n"
        "sys.modules['aigv_assessor_tpu_x'] = types.ModuleType('aigv_assessor_tpu_x')\n"
        "sys.modules['jaxtyping'] = types.ModuleType('jaxtyping')\n"
        "before = harness.forbidden_modules()\n"
        "sys.modules['aigv_assessor_tpu.models'] = types.ModuleType('aigv_assessor_tpu.models')\n"
        "sys.modules['jaxlib'] = types.ModuleType('jaxlib')\n"
        "print(before, harness.forbidden_modules())\n"
    )
    proc = _python(code, ROOT, [ROOT])
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.split() == ["[]", "['aigv_assessor_tpu',", "'jaxlib']"]


def test_the_reference_imports_nothing_of_the_program():
    code = (
        "import sys\n"
        "from portbench import check, weights\n"
        "from portbench.reference import model\n"
        "print(sorted({m.split('.')[0] for m in sys.modules} & "
        "{'aigv_assessor_torch', 'aigv_assessor_tpu', 'jax', 'jaxlib', 'flax'}))\n"
    )
    proc = _python(code, ROOT, [ROOT])
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip() == "[]"
    for path in (ROOT / "portbench" / "reference").rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for n in names:
                assert n.split(".")[0] in {"__future__", "math", "typing", "numpy", "torch"}, n


def test_the_command_refuses_without_a_card(tmp_path):
    """No card here: exit code 2 and no result line. The same in a checkout
    of BENCHMARK.json and portbench/ alone, where no program can run."""
    for root in (ROOT, tmp_path):
        if root == tmp_path:
            shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
            shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                            ignore=shutil.ignore_patterns("__pycache__"))
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        proc = subprocess.run(
            [sys.executable, "portbench/run.py", "--workload", "score-2b-bf16", "--seed",
             str(SEED), "--seconds", "1", "--trace", "0"],
            cwd=root, env=env, capture_output=True, text=True, timeout=600)
        assert proc.returncode == 2 and proc.stdout == "", proc.stderr[-2000:]


def test_without_the_program_a_run_fails(tmp_path):
    """In a directory that holds only BENCHMARK.json and portbench/, the run
    cannot import the program and ends with an error, printing no result."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("from portbench import harness, spec\n"
            f"harness.run_cell(spec.load_cell('score-2b-bf16'), {SEED}, 0.5, False, 'cpu')\n"
            "print('{}')\n")
    proc = _python(code, tmp_path, [tmp_path])
    assert proc.returncode != 0 and proc.stdout == ""
    assert "aigv_assessor_torch" in proc.stderr
