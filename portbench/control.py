"""The control of a cell's comparison, at the cell's own size.

    python3 portbench/control.py --workload <cell> --seed <n> [--seed <n> ...]

For each seed: the cell's pool, made as a run makes it, and the cell's
entry's ``control``: the reference in the program's place with the lossless
guarantee broken (the lowest bit of every sample cleared), compared as a
run compares.  Prints each number beside its limit, one line a seed; a
sound comparison reads every seed over its limit.  Runs on the CUDA device
as a run does, since the pool's draws are the device's, and refuses
without one.  Not part of a run.
"""
import argparse
import json
import pathlib
import sys
import time

sys.path[0] = str(pathlib.Path(__file__).resolve().parents[1])

import numpy as np  # noqa: E402
import torch  # noqa: E402

from portbench import generate, harness  # noqa: E402


def main(argv: list[str]) -> int:
    p = argparse.ArgumentParser(prog="portbench/control.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, action="append", required=True)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("refused: the control needs a CUDA device", file=sys.stderr)
        return 2
    spec = harness.Spec.load(args.workload)
    entry = harness.entry_module(spec.work["entry"])
    dev = torch.device("cuda")
    failed_all = True
    for seed in args.seed:
        t0 = time.perf_counter()
        corpora = generate.pool(spec.config["images"], spec.work["pool"],
                                seed, dev)
        checks = entry.control(corpora, spec.work,
                               np.random.default_rng([seed, 0x5EED]))
        over = any(v > lim for v, lim in checks.values())
        failed_all &= over
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "fails": over, "seconds": time.perf_counter() - t0,
                          "checks": {k: {"value": v, "limit": lim}
                                     for k, (v, lim) in checks.items()}}),
              flush=True)
    return 0 if failed_all else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
