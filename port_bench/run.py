"""Run one cell of the port's benchmark once and print its result line.

    python3 port_bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell comes from BENCHMARK.json at the checkout's root; its
configuration (`port_bench/configs/<config>.json`) and traffic mix
(`port_bench/traffic/<traffic>.json`) are found by name, and the traffic
file names the loop that drives it (`port_bench/entries/<entry>.py`). With
`--trace 0` the result carries the cell's end-to-end metrics, with
`--trace 1` its per-layer metrics, each read by
`port_bench/metrics/<name>.py`. The run needs a CUDA card: without one, or
with a JAX module loaded when the window has closed, it exits non-zero and
prints no result.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# any kernel cache of the program or of Triton stays inside the checkout
os.environ.setdefault("TRITON_CACHE_DIR",
                      os.path.join(ROOT, "gradient_sdf_tpu_torch", "_build",
                                   "triton"))


def parse(argv=None):
    p = argparse.ArgumentParser("port_bench")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    from port_bench import harness

    args = parse(argv)
    try:
        bench = harness.benchmark(ROOT)
        cell = harness.cell(bench, args.workload)
        harness.require_cards(cell["chips"])
        cfg = harness.config_of(bench, cell["config"], ROOT)
        traffic = harness.data_file("traffic", cell["traffic"], ROOT)
        loop = harness.entry(traffic["entry"], ROOT)
        e2e, layer = harness.cell_metrics(bench, args.workload)
        import torch

        out = loop.run(cfg=cfg, traffic=traffic, seed=args.seed,
                       seconds=args.seconds, trace=bool(args.trace),
                       device=torch.device("cuda", 0), chips=cell["chips"],
                       t_process=T_PROCESS,
                       readers=harness.kernel_readers(layer, ROOT))
    except harness.BenchError as e:
        print(f"port_bench: {e}", file=sys.stderr)
        return 2
    found = harness.forbidden_modules()
    if found:
        print(f"port_bench: JAX modules loaded in this process: {found}",
              file=sys.stderr)
        return 3
    result = harness.assemble(out, e2e, layer, bool(args.trace))
    harness.emit(result, out["checks"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
