"""The readings that a cell's limits are set from, many seeds in one
process (the benchmark's own runs never run this), from the checkout's
root::

    python3 -m pabench.readings --workload <name> --seeds 11,12,13 \
        --seconds 3 [--control]

For each seed, one short window at the cell's own sizes and the check
after it, with the program (the lower readings) or with the check's
control in its place (``--control``: the readings that must fail).  One
JSON line a seed: the numbers compared, ``correct``, ``step_ms`` and the
peak of device memory.
"""

import argparse
import json
import sys
import time

from pabench import harness


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--control", action="store_true")
    args = p.parse_args(argv)
    wl, cfg = harness.find_cell(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        r = harness.run_cell(wl, cfg, seed, args.seconds, False, "cuda",
                             time.perf_counter(), control=args.control)
        print(json.dumps({
            "workload": args.workload, "seed": seed,
            "control": args.control, "correct": r["correct"],
            "checks": {k: c["value"] for k, c in r["checks"].items()},
            "step_ms": r["metrics"]["step_ms"]["value"],
            "peak_hbm_gib": r["metrics"]["peak_hbm_gib"]["value"],
            "steps": r["attempted"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
