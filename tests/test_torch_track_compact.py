"""The tracker's compaction kernel's wrapper (gradient_sdf_tpu_torch/ops/
kernels/track_compact.py), the GN loop's device-side count, and the
tracked-and-fused frame, against the JAX package.

Depth frames are made with numpy from a seed (NaN pixels, depths below
z_min, above z_max, zeros) or rendered by the JAX package's analytic
renderer for the map of tests/test_torch_tracker.py (its `setup` fixture: 8
frames fused by the JAX package at 160x120, carried into the port).

On the CPU the wrapper runs the plain version, `track_compact_reference`
(`pts_cam[mask]` written into the buffer); the CUDA kernel has no CPU mode,
and the `gpu`-marked tests hold it to that plain version on a card.

Tolerances, with their reasons:
  * compaction vs the JAX `backproject_grid` + z-gate (tracker.py:193-194):
    count and order exact, points within 1 ulp: both divide (u - cx) / fx
    as IEEE divisions (the JAX package when eager, the port on every
    device), so 0 is expected; a reciprocal product would part by 1 ulp;
  * kernel vs plain on the card: count and points bit for bit;
  * the tracked, then fused frame vs the JAX `track_frame` and
    `fuse_frame`: poses 1e-5 (test_torch_tracker.py's POSE_TOL, in a case
    that stops within 4 iterations), iterations and residual count exact;
    maps fused at one pose with the port's normals (as test_torch_fusion.py
    does): structure exact, fields atol 1e-5 (test_torch_fusion.py's ATOL:
    float32 sums of a few samples a voxel in another order) on all but
    0.5% of the observed voxels: at a tracked pose a sample within an ulp
    of a voxel plane may round to the neighbouring voxel in one package
    (ROADMAP section 3's voxel-plane ties; PARITY.md saw 4% between float32
    implementations; 11 of 10,851 voxels here).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from gradient_sdf_tpu.models import tracker as jtr
from gradient_sdf_tpu.ops import fusion as jfu
from gradient_sdf_tpu.ops import normals as jnorm
from gradient_sdf_tpu_torch.config import PipelineConfig, TrackerConfig
from gradient_sdf_tpu_torch.models import tracker as ttr
from gradient_sdf_tpu_torch.models.grad_sdf import GradSdfMap
from gradient_sdf_tpu_torch.ops import fusion as tfu
from gradient_sdf_tpu_torch.ops import normals as tnorm
from gradient_sdf_tpu_torch.ops.kernels import gn_track as gt
from gradient_sdf_tpu_torch.ops.kernels import track_compact as tc
from gradient_sdf_tpu_torch.utils import interop

from test_torch_tracker import (FCFG, GCFG, K, POSE_TOL, _perturbed,  # noqa: F401
                                setup)

FIELD_TOL = 1e-5
OFF_VOXELS = 5e-3


def _depth(seed, H=45, W=61):
    """Depths over and beyond [z_min, z_max], NaNs and zeros."""
    rng = np.random.default_rng(seed)
    d = rng.uniform(0.0, FCFG.z_max * 1.3, (H, W)).astype(np.float32)
    d[rng.random((H, W)) < 0.05] = np.nan
    d[rng.random((H, W)) < 0.05] = 0.0
    d[rng.random((H, W)) < 0.03] = FCFG.z_min * 0.5
    return d


def _jax_compact(d, sampling):
    pj, zj = jtr.backproject_grid(jnp.asarray(d), jnp.asarray(K), sampling)
    keep = np.asarray((zj > FCFG.z_min) & (zj < FCFG.z_max))
    return np.asarray(pj)[keep]


@pytest.mark.parametrize("sampling", [1, 2, 3])
def test_compaction_matches_jax(sampling):
    d = _depth(sampling)
    want = _jax_compact(d, sampling)
    buf = tc.new_buffer(d.shape, sampling, "cpu")
    tc.reset_launch_count()
    pts, count = tc.track_compact(torch.from_numpy(d), K, FCFG.z_min,
                                  FCFG.z_max, sampling, buf)
    assert tc.launch_count == 0
    assert pts is buf.pts and count is buf.count
    assert count.dtype == torch.int32 and count.shape == (1,)
    n = int(count)
    assert n == want.shape[0] > 100
    rows, cols = tc.strided_shape(d.shape, sampling)
    assert pts.shape == (rows * cols, 3)
    np.testing.assert_array_max_ulp(pts[:n].numpy(), want, maxulp=1)
    assert np.isfinite(pts[:n].numpy()).all()


def test_compaction_equals_compact_points_and_reuses_its_buffer():
    """The plain version is `compact_points` in the buffer's first rows; a
    second frame reuses the buffer."""
    buf = tc.new_buffer((45, 61), 2, "cpu")
    tcfg = TrackerConfig(sampling=2)
    for seed in (4, 5):
        d = torch.from_numpy(_depth(seed))
        pts, count = tc.track_compact(d, K, FCFG.z_min, FCFG.z_max, 2, buf)
        want = ttr.compact_points(d, K, FCFG, tcfg)
        assert torch.equal(pts[:int(count)], want)
    with pytest.raises(ValueError):
        tc.track_compact(torch.from_numpy(_depth(6, 44)), K, FCFG.z_min,
                         FCFG.z_max, 2, buf)


@pytest.mark.parametrize("shape,sampling,tiles", [
    ((480, 640), 1, 120), ((480, 640), 2, 60), ((960, 1280), 1, 480),
    ((961, 1281), 2, 121), ((45, 61), 3, 4), ((45, 61), 1, 12)])
def test_buffer_has_a_status_word_per_tile(shape, sampling, tiles):
    """The kernel's tiles are whole strided rows, min(4, 3072 // cols) of
    them: a VGA frame at stride 1 is 120 tiles (one read of 128 status
    words in the look-back covers every predecessor), a 1280 x 960 frame
    480 (the look-back walks back in rounds)."""
    assert tc.tile_count(shape, sampling) == tiles
    assert tc.new_buffer(shape, sampling, "cpu").status.shape == (tiles,)


def test_map_keeps_one_buffer_per_camera():
    m = GradSdfMap(PipelineConfig(), device="cpu")
    a = m.track_buffer((120, 160), 1)
    assert m.track_buffer((120, 160), 1) is a
    b = m.track_buffer((120, 160), 2)
    assert b is not a and b.pts.shape == (60 * 80, 3)


def test_gn_track_reads_the_count(setup):
    """`gn_track(..., count=)` on a buffer with stale rows past the count
    = `gn_track` on the count's rows alone."""
    _, poses, _, tgrid, depths = setup
    R0, t0 = (torch.from_numpy(a) for a in _perturbed(*poses[4]))
    buf = tc.new_buffer((120, 160), 1, "cpu")
    buf.pts.fill_(0.7)   # stale rows: they must not count
    pts, count = tc.track_compact(torch.from_numpy(depths[4]), K, FCFG.z_min,
                                  FCFG.z_max, 1, buf)
    kw = dict(num_iterations=3, damping=1.0, conv_sq=1e-6)
    Ra, ta, Rb, tb = R0.clone(), t0.clone(), R0.clone(), t0.clone()
    sa = gt.gn_track(pts, Ra, ta, tgrid, GCFG, FCFG, count=count, **kw)
    sb = gt.gn_track(pts[:int(count)].clone(), Rb, tb, tgrid, GCFG, FCFG, **kw)
    assert torch.equal(sa, sb) and torch.equal(Ra, Rb) and torch.equal(ta, tb)
    with pytest.raises(ValueError, match="count"):
        gt.gn_track(pts, Ra, ta, tgrid, GCFG, FCFG, count=count.long(), **kw)


@pytest.fixture
def port_normals_in_jax(monkeypatch):
    """The JAX fusion takes the port's normals (test_torch_fusion.py's
    `same_normals`), so that the map comparison isolates tracking and
    fusion from the ~2e-3 normal difference."""

    def port_normals(cache, depth):
        pc = tnorm.build_cache(depth.shape[1], depth.shape[0], K,
                               window=cache.window, device="cpu")

        def host(d):
            return tnorm.compute_normals(pc, torch.from_numpy(np.array(d))).numpy()

        return jax.pure_callback(
            host, jax.ShapeDtypeStruct(tuple(depth.shape) + (3,), jnp.float32),
            depth)

    monkeypatch.setattr(jfu, "compute_normals", port_normals)


def test_track_frame_then_fuse_frame_match_jax(setup, port_normals_in_jax):
    """The slice through the port's plain paths: frame 4 tracked from a
    perturbed pose (`track_frame`), then fused (`fuse_frame`), against the
    JAX package's `track_frame` and `fuse_frame`. Both maps are fused at the
    JAX package's pose, so that the map comparison is exact in structure
    (a pose POSE_TOL apart moves samples across voxel planes)."""
    _, poses, jgrid, tgrid, depths = setup
    R0, t0 = _perturbed(*poses[4])
    tcfg = TrackerConfig(conv_threshold=5e-3)
    d = depths[4]
    rj = jtr.track_frame(jgrid, jnp.asarray(d), jnp.asarray(K),
                         jnp.asarray(R0), jnp.asarray(t0), GCFG, FCFG, tcfg)
    rt = ttr.track_frame(tgrid, torch.from_numpy(d), K, torch.from_numpy(R0),
                         torch.from_numpy(t0), GCFG, FCFG, tcfg)
    assert rt.converged == bool(rj.converged) and rt.converged
    assert rt.num_iters == int(rj.num_iters) <= 4
    assert rt.num_valid == int(rj.num_valid) > 1000
    np.testing.assert_allclose(rt.R.numpy(), np.asarray(rj.R), atol=POSE_TOL)
    np.testing.assert_allclose(rt.t.numpy(), np.asarray(rj.t), atol=POSE_TOL)
    jc = jnorm.build_cache(160, 120, K, window=5)
    pc = tnorm.build_cache(160, 120, K, window=5, device="cpu")
    jg = jfu.fuse_frame(jgrid, jnp.asarray(d), jc, rj.R, rj.t, GCFG, FCFG)
    own = type(tgrid)(*(a.clone() for a in tgrid))
    tg = tfu.fuse_frame(own, torch.from_numpy(d), pc,
                        torch.from_numpy(np.array(rj.R)),
                        torch.from_numpy(np.array(rj.t)), GCFG, FCFG)
    a = interop.grid_to_numpy(tg)
    b = {k: np.asarray(v) for k, v in jg._asdict().items()}
    for k in ("directory", "num_active", "block_coords", "overflow"):
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert a["weight"].sum() > np.asarray(jgrid.weight).sum()   # fused
    off = np.zeros(a["weight"].shape, bool)
    for k in ("weight", "dist", "grad_x", "grad_y", "grad_z"):
        off |= ~np.isclose(a[k], b[k], rtol=0.0, atol=FIELD_TOL)
    observed = int(((a["weight"] > 0) | (b["weight"] > 0)).sum())
    assert observed > 1000 and off.sum() <= OFF_VOXELS * observed, off.sum()


@pytest.mark.gpu
@pytest.mark.parametrize("sampling,size", [(1, (61, 45)), (2, (61, 45)),
                                           (3, (61, 45)), (1, (640, 480)),
                                           (2, (640, 480)), (1, (1280, 960)),
                                           (3, (640, 480)), (1, (643, 481)),
                                           (2, (1281, 961)), (1, (3, 7))])
def test_cuda_kernel_matches_plain_bit_for_bit(sampling, size):
    """On a card: the kernel's count and points = the plain version's on
    the card, bit for bit, in order; one launch a call, and the count
    stays on the device; three frames into one buffer (each launch's
    status words told from the last's by their epoch)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    W, H = size
    buf = tc.new_buffer((H, W), sampling, "cuda")
    ref = tc.new_buffer((H, W), sampling, "cuda")
    tc.reset_launch_count()
    for seed in (7, 8, 7):
        d = torch.from_numpy(_depth(seed, H, W)).cuda()
        pts, count = tc.track_compact(d, K, FCFG.z_min, FCFG.z_max, sampling,
                                      buf)
        torch.cuda.synchronize()
        assert count.is_cuda and int(buf.next_tile) == 0
        want, wcount = tc.track_compact_reference(d, K, FCFG.z_min,
                                                  FCFG.z_max, ref)
        n = int(wcount)
        assert int(count) == n > 0
        assert torch.equal(pts[:n], want[:n])
    assert tc.launch_count == buf.launches == 3


@pytest.mark.gpu
def test_cuda_track_frame_makes_one_host_sync(setup):
    """On a card `launch_track` (the compaction and the loop kernel) makes
    no host sync and no `nonzero` call; `track_frame` reads the status once
    and equals the loop kernel on `compact_points`' points."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the CUDA map's path)")
    from torch.profiler import ProfilerActivity, profile

    _, poses, _, tgrid, depths = setup
    cg = type(tgrid)(*(a.cuda() for a in tgrid))
    R0, t0 = (torch.from_numpy(a).cuda() for a in _perturbed(*poses[4]))
    depth = torch.from_numpy(depths[4]).cuda()
    tcfg = TrackerConfig(conv_threshold=5e-3)
    buf = tc.new_buffer(depth.shape, 1, "cuda")
    ttr.launch_track(cg, depth, K, R0, t0, GCFG, FCFG, tcfg, compact=buf)
    torch.cuda.synchronize()
    tc.reset_launch_count()
    gt.reset_launch_count()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            R, t, status = ttr.launch_track(cg, depth, K, R0, t0, GCFG, FCFG,
                                            tcfg, compact=buf)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert tc.launch_count == gt.loop_launch_count == 1
    assert not [e for e in prof.key_averages() if "nonzero" in e.key]
    Rc, tc_ = R0.clone(), t0.clone()
    st = gt.gn_track(ttr.compact_points(depth, K, FCFG, tcfg), Rc, tc_, cg,
                     GCFG, FCFG, num_iterations=tcfg.num_iterations,
                     damping=tcfg.damping, conv_sq=tcfg.conv_threshold ** 2)
    assert torch.equal(status, st) and torch.equal(R, Rc) and torch.equal(t, tc_)
    res = ttr.track_frame(cg, depth, K, R0, t0, GCFG, FCFG, tcfg, compact=buf)
    assert torch.equal(res.R, Rc) and torch.equal(res.t, tc_)


def test_bench_switches_match_the_kernel_source():
    """`tools/track_bench.py` takes the kernel apart by one-switch builds of a
    copy of its source: the source is one of the designs its table knows,
    and every switch's anchor is in it exactly once."""
    import os

    from gradient_sdf_tpu_torch.ops.kernels import _build
    from gradient_sdf_tpu_torch.tools import track_bench

    with open(os.path.join(_build.CSRC, "track_compact.cu")) as f:
        text = f.read()
    table = track_bench.COMPACT_SWITCHES
    designs = [d for d, (mark, _) in table.items() if mark in text]
    assert len(designs) == 1
    for name, edits in table[designs[0]][1].items():
        for old, _ in edits:
            assert text.count(old) == 1, name
