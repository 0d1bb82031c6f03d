"""Fixtures of the harness's CPU tests: a checkout with tiny cells added as
files and entries only."""

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TINY_TRAFFIC = {
    "tiny_offline": {"driver": "offline", "batch": 2, "frames": 8, "text_tokens": 16,
                     "pool": 4, "warmup_chunks": 1},
    "tiny_service": {"driver": "service", "batch": 2, "max_wait_ms": 5, "frames": 8,
                     "text_tokens": 16, "pool": 4, "rate_per_s": 20.0, "clients": 8,
                     "warmup_batches": 1, "check_requests": 4},
}
# fp32 program against the fp32 reference: rounding alone
TINY_LIMITS = {"score_gap": 1e-4, "score_head_gap": 1e-4, "features_gap": 1e-4, "motion_gap": 1e-4,
               "readout_gap": 1e-4}


def add_tiny_cells(root: Path) -> dict:
    """Add tiny cells to the checkout at `root` as new files and entries:
    their configurations, traffic mixes and limits, and the workloads."""
    pb = root / "portbench"
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {"tiny-score": ("tiny", "tiny_offline"), "tiny-qknorm-score": ("tiny_qknorm", "tiny_offline"),
             "tiny-serve": ("tiny", "tiny_service")}
    for name in ("tiny", "tiny_qknorm"):
        shutil.copy(pb / "tests" / f"{name}.json", pb / "configs" / f"{name}.json")
        bench["configs"].append({"name": name, "source": "the port's AssessorConfig.tiny",
                                 "file": f"portbench/configs/{name}.json", "reduced": [],
                                 "why": "CPU tests"})
    for name, traffic in TINY_TRAFFIC.items():
        (pb / "traffic" / f"{name}.json").write_text(json.dumps(traffic))
    for cell, (config, traffic) in cells.items():
        limits = ({k: v for k, v in TINY_LIMITS.items() if k != "features_gap"}
                  if "serve" in cell else TINY_LIMITS)
        (pb / "limits" / f"{cell}.json").write_text(json.dumps(limits))
        bench["workloads"].append({"name": cell, "config": config, "traffic": traffic,
                                   "chips": 1, "why": "CPU tests"})
        for m in bench["end_to_end"] + bench["per_layer"]:
            w = m.get("workloads")
            if w is not None and any(x.startswith("serve" if "serve" in cell else "score")
                                     for x in w):
                w.append(cell)
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return bench


@pytest.fixture
def tiny_root(tmp_path):
    """A copy of the benchmark's files with the tiny cells added."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    add_tiny_cells(tmp_path)
    return tmp_path
