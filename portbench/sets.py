"""Sets of runs of one cell, each a process of its own as the check makes
them, and the spread each bound is set from:

    python3 -m portbench.sets --workload <name> --seeds 1,2,3,4,5,6 \
        --sets 2 [--trace 0] [--seconds 10] [--out results.jsonl]

Every set runs the same seeds in order.  For each end-to-end metric it
prints each set's median and spread (the distance between the first and
the third quartile, `statistics.quantiles(values, n=4)`, over the median)
and the wider of the sets' spreads; `correct` and the compared numbers of
every run; and, for `setup_s`, the first run's (which may build) apart.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]


def spread(values: list[float]) -> float:
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--sets", type=int, default=2)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--seconds", type=float, default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    seconds = args.seconds or json.loads((ROOT / "BENCHMARK.json").read_text())["run_seconds"]
    seeds = [int(s) for s in args.seeds.split(",") if s]
    out = open(args.out, "a") if args.out else None
    sets = []
    for k in range(args.sets):
        lines = []
        for seed in seeds:
            t0 = time.perf_counter()
            p = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", args.workload,
                                "--seed", str(seed), "--seconds", str(seconds),
                                "--trace", str(args.trace)],
                               cwd=ROOT, capture_output=True, text=True)
            wall = time.perf_counter() - t0
            last = p.stdout.strip().splitlines()[-1] if p.stdout.strip() else ""
            try:
                line = json.loads(last)
            except json.JSONDecodeError:
                line = {"error": p.stderr[-1500:]}
            rec = {"workload": args.workload, "set": k, "seed": seed, "rc": p.returncode,
                   "wall_s": wall, "result": line}
            print(json.dumps(rec), flush=True)
            if out:
                out.write(json.dumps(rec) + "\n")
                out.write(json.dumps({"stdout_head": p.stdout.splitlines()[:-1]}) + "\n")
                out.flush()
            lines.append(line)
        sets.append(lines)
    summary = {"workload": args.workload, "seconds": seconds, "metrics": {}}
    names = sorted({m for s in sets for line in s for m in line.get("metrics", {})})
    for name in names:
        per = []
        for i, s in enumerate(sets):
            vals = [line["metrics"][name]["value"] for line in s if name in line.get("metrics", {})]
            if name == "setup_s" and i == 0:
                vals = vals[1:]          # the first run may build: recorded apart
            if len(vals) >= 2:
                per.append({"median": statistics.median(vals), "spread": spread(vals),
                            "values": vals})
        summary["metrics"][name] = {"sets": per,
                                    "widest": max((p["spread"] for p in per), default=None)}
    summary["correct"] = [line.get("correct") for s in sets for line in s]
    print(json.dumps(summary), flush=True)
    if out:
        out.write(json.dumps(summary) + "\n")
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
