"""The readings the check's limits are set from, several seeds in one
process (the kernels built and the modules imported once):

    python3 -m portbench.control --workload <name> --mode program|control \
        --seeds <n> [<n> ...] [--seconds 2]

`program`: each seed's run as the benchmark makes it, its numbers (the
lower readings).  `control`: the reference in TF32, the nearest precision
below the configuration's fp32, put in the program's place (the upper
readings).  Prints one JSON line a seed: {"seed", "mode", "checks"}.  The
benchmark's own runs never run the control.
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--mode", choices=("program", "control"), required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    a = ap.parse_args(argv)
    from portbench.run import run_cell, steady_host

    steady_host()
    import torch

    if not torch.cuda.is_available():
        print("portbench.control: no CUDA device", file=sys.stderr)
        return 2
    for seed in a.seeds:
        result, run = run_cell(a.workload, seed, a.seconds, 0, torch.device("cuda", 0),
                             fault="control" if a.mode == "control" else None)
        print(json.dumps({"seed": seed, "mode": a.mode, "checks": result["checks"],
                          "readings": run["check_readings"], "metrics": result["metrics"],
                          "memory_peak_bytes": result["device"]["memory_peak_bytes"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
