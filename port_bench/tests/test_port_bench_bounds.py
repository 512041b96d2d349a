"""The frozen bounds held to the program's bench tools on the same inputs,
so that a drift in either is seen at once; and the reference's counts of
the work held to the tools' counts."""

import pytest
import torch

from conftest import small_scan_cell


def _map_and_frame():
    from port_bench import scene
    from port_bench.entries import scan3d_loop as E
    from gradient_sdf_tpu_torch.models.grad_sdf import GradSdfMap

    _, _, cfg, traffic = small_scan_cell()
    dev = torch.device("cpu")
    sc = E.Scene(cfg, traffic, 5, dev)
    m = GradSdfMap(E.program_config(cfg), device=dev)
    for i in (0, 1):
        m.update(sc.frames[i], sc.K, scene.pose_tensors(sc.poses[i], dev))
    return cfg, sc, m


def test_gn_loop_operations_match_track_bench():
    from port_bench import bounds
    from gradient_sdf_tpu_torch.ops.kernels import track_compact
    from gradient_sdf_tpu_torch.tools import track_bench

    _, sc, m = _map_and_frame()
    d = torch.as_tensor(sc.frames[1])
    pts = track_compact.compact(d, sc.K, 0.5, 3.5, 1)
    R, t = (torch.as_tensor(a) for a in sc.poses[1])
    for residuals in ([pts.shape[0]], [1000, 1200, 1300], [0]):
        tool = track_bench.loop_bound(pts, m.grid, m.cfg.grid,
                                      [(R, t)] * len(residuals), residuals)
        assert bounds.gn_loop_ops_ms(pts.shape[0], residuals) == pytest.approx(
            tool["ops_ms"], rel=1e-12)


def test_fuse_integrate_bound_matches_fusion_bench():
    from port_bench import bounds
    from port_bench.entries import scan3d_loop as E
    from gradient_sdf_tpu_torch.tools import fusion_bench

    cfg, sc, m = _map_and_frame()
    d = torch.as_tensor(sc.frames[1])
    R, t = (torch.as_tensor(a) for a in sc.poses[1])
    tool = fusion_bench.fuse_bounds(m, d, R, t, misses=0)
    ref = E.Reference(cfg, sc.K, torch.device("cpu"))
    counts = E.frame_counts(ref, sc.frames[1], *sc.poses[1])
    for k in ("rows", "blocks", "sectors", "valid", "tiles"):
        assert counts[k] == tool[k], k
    ms, by = bounds.fuse_integrate_bound_ms(**counts)
    assert ms == pytest.approx(tool["integrate"][0], rel=1e-12)
    assert by == tool["integrate"][1]
