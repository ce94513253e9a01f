"""The benchmark's command: one run of one cell, from a checkout's root.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints the checks last on standard error and one JSON line last on standard
output; exits nonzero, printing no result, without the CUDA devices the cell
asks for, or where the run loaded JAX or the JAX package.
"""
import time

T_PROCESS = time.perf_counter()

import pathlib  # noqa: E402
import sys  # noqa: E402

# the checkout's root in place of this script's folder, so that the
# program and the benchmark import as packages
sys.path[0] = str(pathlib.Path(__file__).resolve().parents[1])

from portbench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], T_PROCESS))
