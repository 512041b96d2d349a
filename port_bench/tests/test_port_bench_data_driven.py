"""A configuration, a traffic mix and a per-layer metric added as new
files and new BENCHMARK.json entries are found by name, with no file that
is there edited; a new kernel's roofline among them."""

import hashlib
import json
import os
import shutil

import pytest
import torch

from conftest import ROOT, small_scan_cell


def _digests(root):
    out = {}
    for d, _, files in os.walk(os.path.join(root, "port_bench")):
        for f in files:
            if f.endswith((".py", ".json")) and "__pycache__" not in d:
                p = os.path.join(d, f)
                with open(p, "rb") as fh:
                    out[os.path.relpath(p, root)] = hashlib.sha256(fh.read()).hexdigest()
    return out


NEW_ROOFLINE = """
from port_bench.harness import roofline

KERNELS = ("fals_normals",)


def bound_ms(frame):
    return 52 * frame.width * frame.height / 3.35e12 * 1e3


def read(trace):
    return roofline(trace, "fals_normals_roofline")
"""


class FakeStretch:
    """A profiled stretch in which every kernel asked for took 0.5 ms."""

    def __init__(self):
        self.asked = {}

    def parse(self, kernels):
        self.asked = dict(kernels)
        return {"kernel_ms": {k: 0.5 for k in kernels}, "busy_s": 1e-3,
                "window_s": 2e-3, "breakdown": {"device_ops": [], "idle_gaps": []}}


def _frames():
    """Two profiled frames of the small scan cell, as its loop makes them."""
    from port_bench.entries import scan3d_loop as E

    _, _, cfg, traffic = small_scan_cell()
    dev = torch.device("cpu")
    sc = E.Scene(cfg, traffic, 3, dev)
    ref, cache = E.Reference(cfg, sc.K, dev), {}
    return [E.FrameFacts(ref, sc, i, sc.poses[i], 4, 1000, True, cache)
            for i in (1, 2)]


def test_new_files_are_picked_up(tmp_path):
    from port_bench import harness

    root = str(tmp_path)
    shutil.copytree(os.path.join(ROOT, "port_bench"), os.path.join(root, "port_bench"),
                    ignore=shutil.ignore_patterns("__pycache__", "_out"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    before = _digests(root)
    b = harness.benchmark(root)
    old = b["workloads"][0]
    cfg = harness.config_of(b, old["config"], root)
    traffic = harness.data_file("traffic", old["traffic"], root)
    # the new files
    cfg["grid"]["voxel_size"] = 0.02
    with open(os.path.join(root, "port_bench/configs/new-cfg.json"), "w") as f:
        json.dump(cfg, f)
    traffic["camera"]["frames"] = 230
    with open(os.path.join(root, "port_bench/traffic/new-mix.json"), "w") as f:
        json.dump(traffic, f)
    with open(os.path.join(root, "port_bench/metrics/new_metric.py"), "w") as f:
        f.write("def read(trace):\n    return 42.0\n")
    with open(os.path.join(root, "port_bench/metrics/fals_normals_roofline.py"),
              "w") as f:
        f.write(NEW_ROOFLINE)
    # the new entries
    b["configs"].append(dict(b["configs"][0], name="new-cfg",
                             file="port_bench/configs/new-cfg.json"))
    b["workloads"].append(dict(old, name="new-cell", config="new-cfg",
                               traffic="new-mix"))
    for m in b["end_to_end"]:
        if old["name"] in m.get("workloads", []):
            m["workloads"].append("new-cell")
    b["per_layer"].append({"name": "new_metric", "unit": "ms", "better": "lower",
                           "source": "program_span", "layer": "device",
                           "moves": b["per_layer"][0]["moves"],
                           "workloads": ["new-cell"]})
    b["per_layer"].append({"name": "fals_normals_roofline", "unit": "%",
                           "better": "higher", "source": "device_trace",
                           "layer": "ops/kernels/fals_normals",
                           "moves": b["per_layer"][0]["moves"],
                           "workloads": ["new-cell"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(b, f)
    b = harness.benchmark(root)
    cell = harness.cell(b, "new-cell")
    assert harness.config_of(b, cell["config"], root)["grid"]["voxel_size"] == 0.02
    t = harness.data_file("traffic", cell["traffic"], root)
    assert t["camera"]["frames"] == 230
    assert harness.entry(t["entry"], root).run
    _, layer = harness.cell_metrics(b, "new-cell")
    assert "new_metric" in {m["name"] for m in layer}
    assert harness.read_metric("new_metric", {}, root) == 42.0
    # the new kernel is timed and bounded with no file that is there edited
    readers = harness.kernel_readers(layer, root)
    assert set(readers) == {"fals_normals_roofline"}
    _, old_layer = harness.cell_metrics(b, old["name"])
    assert set(harness.kernel_readers(old_layer, root)) == {
        "gn_track_loop_roofline", "fuse_integrate_roofline"}
    stretch = FakeStretch()
    tr = harness.rooflines(stretch, readers, _frames())
    assert stretch.asked["fals_normals_roofline"] == ("fals_normals",)
    assert tr["bound_ms"]["fals_normals_roofline"] == pytest.approx(
        2 * 52 * 320 * 240 / 3.35e12 * 1e3)
    assert harness.read_metric("fals_normals_roofline", tr, root) == pytest.approx(
        100.0 * tr["bound_ms"]["fals_normals_roofline"] / 0.5)
    after = _digests(root)
    assert all(after[k] == v for k, v in before.items())
