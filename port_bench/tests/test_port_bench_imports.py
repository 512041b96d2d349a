"""No module that a run loads is JAX's or the JAX package's (top-level
names compared whole), and the reference loads nothing of the program."""

import json
import os
import subprocess
import sys

from conftest import ROOT

PROBE = r"""
import json, sys
sys.path.insert(0, {root!r})
from port_bench import harness
bench = harness.benchmark()
for w in bench["workloads"]:
    traffic = harness.data_file("traffic", w["traffic"])
    loop = harness.entry(traffic["entry"])
    loop.program_config(harness.config_of(bench, w["config"]))
    from gradient_sdf_tpu_torch.models import grad_sdf, tracker  # noqa
    e2e, layer = harness.cell_metrics(bench, w["name"])
    for m in layer:
        harness.read_metric(m["name"], {{"spans": {{}}, "counters": {{}}}})
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _tops(code):
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, timeout=300,
                         env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax_module():
    from port_bench import harness

    tops = _tops(PROBE.format(root=ROOT))
    assert "gradient_sdf_tpu_torch" in tops
    assert not tops & set(harness.FORBIDDEN), tops & set(harness.FORBIDDEN)


def test_the_reference_loads_nothing_of_the_program():
    code = (f"import json, sys; sys.path.insert(0, {ROOT!r});"
            "import port_bench.reference.tracker, port_bench.reference.fusion,"
            " port_bench.scene, port_bench.bounds,"
            " port_bench.checks;"
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    tops = _tops(code)
    assert "gradient_sdf_tpu_torch" not in tops and "jax" not in tops
    assert "gradient_sdf_tpu" not in tops


def test_the_check_compares_whole_top_level_names(monkeypatch):
    from port_bench import harness

    monkeypatch.setitem(sys.modules, "jaxlib_like_name", sys)
    assert "jaxlib_like_name" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "gradient_sdf_tpu.ops", sys)
    assert harness.forbidden_modules() == ["gradient_sdf_tpu"]
