"""Readings for the limits of `correct`: the program's and the control's.

    python3 port_bench/calibrate.py --workload <name> --seeds 1 2 3 [--frames 4]

For each seed, in one process: the cell's set-up, then frames of the next
revolution, each judged as a run judges it, once for the program and once
for the control (the plain reference in bfloat16 put in the program's
place, from the program's state before the frame). Prints one JSON line a
seed and a summary: for each compared number the largest program reading
(the lower reading) and the smallest control reading (the upper one).
The benchmark's own runs do not run this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def main(argv=None):
    from port_bench import checks, harness

    p = argparse.ArgumentParser("calibrate")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--frames", type=int, default=4)
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)
    import torch

    bench = harness.benchmark(ROOT)
    cell = harness.cell(bench, a.workload)
    cfg = harness.config_of(bench, cell["config"], ROOT)
    traffic = harness.data_file("traffic", cell["traffic"], ROOT)
    loop = harness.entry(traffic["entry"], ROOT)
    print(harness.power_limit() if a.device == "cuda" else "cpu", flush=True)
    lows, highs = [], []
    for seed in a.seeds:
        r = loop.calibrate(cfg=cfg, traffic=traffic, seed=seed,
                           device=torch.device(a.device), frames=a.frames)
        keys = sorted({k for x in r["program"] + r["control"] for k in x})
        prog = checks.worst(r["program"], keys)
        ctrl = {k: min(x[k] for x in r["control"]) for k in keys}
        ctrl_max = checks.worst(r["control"], keys)
        lows.append(prog)
        highs.append(ctrl_max)
        print(json.dumps({"seed": seed, "program_worst": prog,
                          "control_least": ctrl, "control_worst": ctrl_max}),
              flush=True)
    keys = sorted(lows[0])
    print(json.dumps({"lower_reading": {k: max(x[k] for x in lows) for k in keys},
                      "upper_reading": {k: min(x[k] for x in highs) for k in keys}}),
          flush=True)


if __name__ == "__main__":
    main()
