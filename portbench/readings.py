"""The two readings each check's limit is set between, on the card:

    python3 -m portbench.readings --workload <name> --seeds 1,2,... \
        --control-seeds 1,2,3 --seconds 2

In one process, for each seed: the cell's whole set-up, a short window at
the cell's own load, and the check of the program's outputs (the lower
reading is the largest over the seeds); for each control seed, the same
window's held outputs judged with the control in the program's place, the
reference with its DFT in bfloat16 (the upper reading is the smallest).
Prints one JSON line per seed and a summary.  The benchmark's own runs do
not run the control.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time

import torch

from portbench import harness


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("FAIL: no CUDA card", file=sys.stderr)
        return 3
    cell = harness.cell(args.workload)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    lower, upper = {}, {}
    for seed in seeds:
        t0 = time.perf_counter()
        run = harness.Run(cell, seed, torch.device("cuda", 0), t_process=t0)
        run.setup()
        run.loop.window(run, args.seconds, False)
        run.close()
        program = {k: v["value"] for k, v in run.judge().items()}
        for k, v in program.items():
            lower[k] = max(lower.get(k, v), v)
        line = {"seed": seed, "units": run.units, "held": len(run.held),
                "pixels": run.pixels_checked, "program": program}
        if seed in controls:
            control = {k: v["value"] for k, v in run.judge("bf16").items()}
            for k, v in control.items():
                upper[k] = min(upper.get(k, v), v)
            line["control"] = control
        line["seconds"] = time.perf_counter() - t0
        print(json.dumps(line), flush=True)
        del run
        gc.collect()
        torch.cuda.empty_cache()
    print(json.dumps({"workload": args.workload, "seeds": len(seeds),
                      "lower": lower, "upper": upper}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
