"""What every cell shares: the BENCHMARK.json lookup, the card check, the
check that no JAX module is loaded, the profiler's stretch, the metric
readers and the result line."""

from __future__ import annotations

import importlib.util
import json
import math
import os
import re
import sys
import time
from typing import Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "gradient_sdf_tpu")


class BenchError(RuntimeError):
    """A run that cannot give a result (no card, no cell, a JAX module)."""


def load_json(path):
    with open(path) as f:
        return json.load(f)


def benchmark(root: str = ROOT) -> dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise BenchError(f"no workload {name!r} in BENCHMARK.json")


def data_file(kind: str, name: str, root: str = ROOT) -> dict:
    """`port_bench/<kind>/<name>.json`: a configuration or a traffic mix."""
    path = os.path.join(root, "port_bench", kind, name + ".json")
    if not os.path.isfile(path):
        raise BenchError(f"no {kind} file {path}")
    return load_json(path)


def config_of(bench: dict, name: str, root: str = ROOT) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return load_json(os.path.join(root, c["file"]))
    raise BenchError(f"no config {name!r} in BENCHMARK.json")


def _module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def entry(name: str, root: str = ROOT):
    """The loop a traffic file names: `port_bench/entries/<name>.py`."""
    path = os.path.join(root, "port_bench", "entries", name + ".py")
    if not os.path.isfile(path):
        raise BenchError(f"no entry {path}")
    return _module(path, "port_bench_entry_" + name.replace(".", "_"))


def cell_metrics(bench: dict, workload: str):
    """(end-to-end metric entries, per-layer metric entries) of a cell: an
    end-to-end metric without `workloads` is every cell's; a per-layer
    metric without it is every cell's that reports the metric it moves."""
    e2e = [m for m in bench["end_to_end"]
           if workload in m.get("workloads", [workload])]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if workload in m.get("workloads", [workload])
             and m["moves"] in names]
    return e2e, layer


def reader(name: str, root: str = ROOT):
    """The per-layer metric's module, `port_bench/metrics/<name>.py`."""
    path = os.path.join(root, "port_bench", "metrics", name + ".py")
    if not os.path.isfile(path):
        raise BenchError(f"no metric reader {path}")
    return _module(path, "port_bench_metric_" + re.sub(r"\W", "_", name))


def read_metric(name: str, trace: dict, root: str = ROOT):
    """The reader `port_bench/metrics/<name>.py` applied to the trace: a
    number, or None where it finds nothing to read."""
    value = reader(name, root).read(trace)
    return None if value is None else float(value)


def kernel_readers(layer: list, root: str = ROOT) -> dict:
    """{name: module} of the cell's per-layer metrics that time kernels: a
    reader that declares `KERNELS` (words of the kernels' names) and
    `bound_ms(frame)` (the least time of those kernels on one profiled
    frame, or None where they do no work on it)."""
    out = {}
    for m in layer:
        r = reader(m["name"], root)
        if hasattr(r, "KERNELS"):
            out[m["name"]] = r
    return out


# -- the card ---------------------------------------------------------------

def require_cards(chips: int):
    import torch

    if not torch.cuda.is_available():
        raise BenchError("no CUDA card: the benchmark runs only on one")
    if torch.cuda.device_count() < chips:
        raise BenchError(f"the cell needs {chips} cards, "
                         f"{torch.cuda.device_count()} present")


def device_record(dev, chips: int) -> dict:
    import torch

    if dev.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
                "count": chips,
                "memory_peak_bytes": int(torch.cuda.max_memory_allocated(dev))}
    return {"platform": "cpu", "kind": "cpu", "count": 1,
            "memory_peak_bytes": 0}


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole (the port's name begins with the JAX package's)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def power_limit() -> Optional[str]:
    """`nvidia-smi`'s name and power limit of the card, or None."""
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else None


# -- statistics ---------------------------------------------------------------

def percentile(values, q: float) -> float:
    """The q-th percentile, linear between closest ranks (numpy's default)."""
    v = sorted(values)
    if not v:
        return math.nan
    pos = (len(v) - 1) * q / 100.0
    lo = int(math.floor(pos))
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


def mean(values) -> Optional[float]:
    return sum(values) / len(values) if values else None


# -- the profiler's stretch -------------------------------------------------

class Stretch:
    """A bounded stretch of a window under `torch.profiler` (CPU and CUDA
    activities). `mark(name)` brackets host work with a record_function
    range, so that each idle gap of the device can be named by what the
    host was doing."""

    def __init__(self, dev):
        import torch

        self.torch = torch
        self.dev = dev
        self.prof = None
        self.t0 = self.t1 = None

    def _profile(self):
        acts = [self.torch.profiler.ProfilerActivity.CPU]
        if self.dev.type == "cuda":
            acts.append(self.torch.profiler.ProfilerActivity.CUDA)
        return self.torch.profiler.profile(activities=acts)

    def _sync(self):
        if self.dev.type == "cuda":
            self.torch.cuda.synchronize(self.dev)

    def warm(self):
        """Profile one small operation, so that the tracer's own start-up
        (seconds on the card) falls into set-up and not into the window."""
        with self._profile():
            self.torch.ones(8, device=self.dev).sum().item()

    def start(self):
        self._sync()
        self.prof = self._profile()
        self.prof.start()
        self.t0 = time.perf_counter()

    def stop(self):
        self._sync()
        self.t1 = time.perf_counter()
        self.prof.stop()

    def mark(self, name):
        return self.torch.profiler.record_function(name)

    def parse(self, kernels) -> dict:
        """Device intervals of the stretch: {"kernel_ms": {key: ms summed
        over the launches whose name holds `kernels[key]` (a word or a
        tuple of words, a kernel and its finish) as a word},
        "busy_s", "window_s", "breakdown"}. The window is the stretch's
        host clock; busy is the union of the device's operation intervals."""
        from torch.autograd import DeviceType

        dev_ops, host = [], []
        for e in self.prof.events():
            tr = e.time_range
            if e.name.startswith("pb."):
                # the marks; their copies on the device's timeline are
                # annotations, not operations
                if e.device_type != DeviceType.CUDA:
                    host.append((tr.start, tr.end, e.name))
            elif e.device_type == DeviceType.CUDA:
                dev_ops.append((tr.start, tr.end, e.name))
        window_s = self.t1 - self.t0
        kernel_ms = {}
        for key, words in kernels.items():
            words = (words,) if isinstance(words, str) else words
            rx = re.compile("|".join(r"\b" + re.escape(w) + r"\b" for w in words))
            ms = sum(b - a for a, b, n in dev_ops if rx.search(n)) / 1e3
            if ms > 0:
                kernel_ms[key] = ms
        dev_ops.sort()
        busy, gaps, cur_a, cur_b = 0.0, [], None, None
        for a, b, _ in dev_ops:
            if cur_b is None or a > cur_b:
                if cur_b is not None:
                    busy += cur_b - cur_a
                    gaps.append((cur_b, a))
                cur_a, cur_b = a, b
            else:
                cur_b = max(cur_b, b)
        if cur_b is not None:
            busy += cur_b - cur_a
        by_name = {}
        for a, b, n in dev_ops:
            by_name[n] = by_name.get(n, 0.0) + (b - a) / 1e6
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        named = {}
        for a, b in gaps:
            mid = 0.5 * (a + b)
            inside = [h for h in host if h[0] <= mid <= h[1]]
            label = (min(inside, key=lambda h: h[1] - h[0])[2] if inside
                     else "host outside a marked range")
            named[label] = named.get(label, 0.0) + (b - a) / 1e6
        gap_top = sorted(named.items(), key=lambda kv: -kv[1])[:10]
        return {"kernel_ms": kernel_ms, "busy_s": busy / 1e6,
                "window_s": window_s, "device_ops": len(dev_ops),
                "breakdown": {"device_ops": [[n, s] for n, s in top],
                              "idle_gaps": [[n, s] for n, s in gap_top]}}


# -- the result ---------------------------------------------------------------

def judge(checks: dict) -> bool:
    """Every number at or under its limit, and at least one answer
    compared. A limit given as [lo, hi] is a range."""
    ok = True
    for v in checks.values():
        lim, val = v["limit"], v["value"]
        if val is None or (isinstance(val, float) and math.isnan(val)):
            ok = False
        elif isinstance(lim, list):
            ok &= lim[0] <= val <= lim[1]
        else:
            ok &= val <= lim
    return ok


def emit(result: dict, checks: dict):
    """Print each compared number beside its limit as the last lines of
    standard error, and the result as the last line of standard output,
    with the checks under the last key."""
    for k, v in checks.items():
        print(f"check {k}: {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    out = dict(result)
    out["checks"] = checks
    print(json.dumps(out), flush=True)


def assemble(out: dict, e2e: list, layer: list, traced: bool) -> dict:
    """The result line's keys from an entry's output: the end-to-end
    metrics, or with `traced` the per-layer ones that their readers find."""
    metrics = {}
    if traced:
        for m in layer:
            v = read_metric(m["name"], out["trace"])
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for m in e2e:
            metrics[m["name"]] = {"value": float(out["e2e"][m["name"]]),
                                  "unit": m["unit"]}
    device = dict(out["device"])
    res = {"correct": bool(out["correct"]), "attempted": int(out["attempted"]),
           "failed": int(out["failed"]), "metrics": metrics}
    if traced:
        device["busy_s"] = out["trace"]["busy_s"]
        device["window_s"] = out["trace"]["window_s"]
        res["device"] = device
        res["breakdown"] = out["trace"]["breakdown"]
    else:
        res["device"] = device
    return res


def rooflines(stretch, readers: dict, frames: list) -> dict:
    """The stretch's device readings (`Stretch.parse`) over the kernels that
    `readers` (`kernel_readers`) declare, and under each reader's name the
    summed bound of its kernels over the stretch's `frames` (`bound_ms`)."""
    tr = stretch.parse({n: r.KERNELS for n, r in readers.items()})
    tr["bound_ms"] = {}
    for n, r in readers.items():
        b = [x for x in (r.bound_ms(f) for f in frames) if x is not None]
        if b:
            tr["bound_ms"][n] = sum(b)
    return tr


def roofline(trace: dict, name: str):
    """100 x the summed bound over the summed profiler time of the kernels
    of the metric `name` in the stretch; None where either is missing."""
    t = trace.get("kernel_ms", {}).get(name)
    b = trace.get("bound_ms", {}).get(name)
    return None if not t or not b else 100.0 * b / t


def idle_share(trace: dict):
    """100 x (1 - busy / window) of the profiled stretch; None without one."""
    if not trace.get("window_s") or not trace.get("busy_s"):
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
