"""The readings that a cell's limits are set from, in one process.

    python3 benchmark/tools/readings.py --workload <name> --seeds 1 2 3 \
        [--control | --fault <name>] [--seconds 3]

For each seed: one run of the cell (a short window), the numbers compared
to decide ``correct``, one JSON line each. ``--control`` puts the reference
in the program's place at the precision the configuration names below its
own (its ``control``); ``--fault`` plants one of ``harness.faults`` in the
port (in every rank of a multi-chip cell). Both must read worse.
"""

import argparse
import importlib
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

from benchmark.harness import common  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=0.0)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--fault")
    args = ap.parse_args(argv)
    common.set_cache_dirs()
    import torch

    c = common.cell(args.workload)
    kind = c["traffic"]["kind"]
    cell = importlib.import_module(f"benchmark.harness.{kind}_cell")
    control = c["config"][kind]["control"] if args.control else None
    for seed in args.seeds:
        t = time.perf_counter()
        result, readings, _ = cell.run(c, seed, args.seconds, False, "cuda", t,
                                       control=control, fault=args.fault)
        print(json.dumps({"workload": args.workload, "seed": seed, "control": control,
                          "fault": args.fault,
                          "readings": readings, "failed": result["failed"],
                          "e2e": result["e2e"], "s": time.perf_counter() - t}), flush=True)
        del result
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
