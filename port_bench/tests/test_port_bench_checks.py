"""The reference comparison: equal states compare at zero, and a
deliberately perturbed output fails its limit."""

import numpy as np
import torch

from conftest import small_scan_cell


def _state():
    from port_bench.reference import grid as RG

    torch.manual_seed(0)
    g = RG.Grid.empty(8, 16, 8, 0.01, "cpu")
    keys = torch.tensor([5, 77, 300], dtype=torch.int32)
    RG.claim(g, keys, torch.ones(3, dtype=torch.bool))
    for f in g.fields:
        f[:3] = torch.rand(3, 512)
    return g.state()


def _copy(st):
    return {k: (v.clone() if torch.is_tensor(v) else v) for k, v in st.items()}


def test_equal_maps_compare_at_zero():
    from port_bench import checks

    st = _state()
    r = checks.compare_maps(st, _copy(st))
    assert r == {"block_mismatch": 0, "dist_gap_m": 0.0, "weight_gap_rel": 0.0,
                 "grad_gap_rel": 0.0}


def test_perturbed_outputs_fail_their_limits():
    from port_bench import checks

    _, _, _, traffic = small_scan_cell()
    lim = traffic["check"]["limits"]
    st = _state()
    bad = _copy(st)
    bad["dist"][1, 7] += 10 * lim["dist_gap_m"]
    assert checks.compare_maps(st, bad)["dist_gap_m"] > lim["dist_gap_m"]
    bad = _copy(st)
    bad["weight"][2, 0] *= 1.01
    assert checks.compare_maps(st, bad)["weight_gap_rel"] > lim["weight_gap_rel"]
    bad = _copy(st)
    bad["gy"][0, 9] += 0.01
    assert checks.compare_maps(st, bad)["grad_gap_rel"] > lim["grad_gap_rel"]
    bad = _copy(st)
    bad["directory"][77] = -1     # a claimed block lost
    assert checks.compare_maps(st, bad)["block_mismatch"] > lim["block_mismatch"]
    R = np.eye(3, dtype=np.float32)
    t = np.zeros(3, dtype=np.float32)
    g = checks.pose_gaps(R, t, R, t + np.float32(10 * lim["pose_t_gap_m"]))
    assert g["pose_t_gap_m"] > lim["pose_t_gap_m"]
    c, s = np.cos(1e-3), np.sin(1e-3)
    Rz = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], dtype=np.float32)
    g = checks.pose_gaps(R, t, Rz, t)
    assert abs(g["pose_r_gap_rad"] - 1e-3) < 1e-5 and g["pose_r_gap_rad"] > lim["pose_r_gap_rad"]


def test_judge_holds_every_number_to_its_limit():
    from port_bench import harness

    assert harness.judge({"a": {"value": 0.0, "limit": 0}, "b": {"value": 3, "limit": [1, 5]}})
    assert not harness.judge({"a": {"value": 1e-9, "limit": 0}})
    assert not harness.judge({"b": {"value": 0, "limit": [1, 5]}})
    assert not harness.judge({"a": {"value": float("nan"), "limit": 1.0}})


def test_control_fails_and_program_passes_on_the_small_cell():
    """The control (the plain reference in bfloat16 in the program's place)
    against the same limits as the program, on the small cell."""
    from port_bench import checks, harness

    _, _, cfg, traffic = small_scan_cell()
    loop = harness.entry(traffic["entry"])
    r = loop.calibrate(cfg=cfg, traffic=traffic, seed=3, device=torch.device("cpu"),
                       frames=2)
    lim = traffic["check"]["limits"]

    def passes(readings):
        w = checks.worst(readings, lim.keys())
        return all(w[k] <= lim[k] for k in lim)

    assert passes(r["program"]), r["program"]
    assert not passes(r["control"]), r["control"]
