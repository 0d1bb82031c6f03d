"""The benchmark's command: one run of one cell of BENCHMARK.json.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from anywhere in a checkout; it needs the CUDA card(s) the cell asks for
and prints the result as the last line of its standard output.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# the checkout's root in place of this file's folder, whose module names
# (trace, inputs, ...) would shadow others
sys.path[0] = str(ROOT)
# every kernel cache at a fixed path inside the checkout (the program's own
# nvcc builds go to its build/kernels), and no JAX through transformers
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "portbench" / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "portbench" / "torch_extensions")
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"

from portbench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(t_start=T_START))
