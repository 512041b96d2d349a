"""Port fusion (gradient_sdf_tpu_torch/ops/fusion.py), the map wrapper and
the SDF query against the JAX package and the sequential numpy oracle.

Same depth frames (rendered once by the JAX package's analytic renderer and
handed to both as numpy arrays) at the 64x48 camera of tests/test_fusion.py.
On the CPU the port's accumulator is the scatter kernel's plain version.

The JAX fuse_frame runs with the port's FALS normals (the `same_normals`
fixture patches its `compute_normals`; nothing in the JAX package changes).
The two packages' normals differ by up to ~2e-3 (prefix-sum vs banded
matmul box sums, amplified by FALS's 3x3 inverse; compared on their own in
test_torch_core.py), and a pixel whose view angle sits that close to
fusion's 60-degree gate would be fused by one package and not the other.
With shared normals the comparison isolates fusion itself.

Tolerances, with their reasons:
  * structure (directory, block slots, coords, claimed-block order, vis
    bits): exact — same gates, same (pixel, k) candidate order.
  * weight, dist, grad: atol 1e-5 — float32 sums of <= ~30 samples per
    voxel in another order (index_add_ vs XLA scatter).
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from gradient_sdf_tpu import config as jcfg_mod
torch.backends.cuda.matmul.allow_tf32 = False  # float32, as the JAX package
torch.backends.cudnn.allow_tf32 = False
from gradient_sdf_tpu.config import FusionConfig, GridConfig
from gradient_sdf_tpu.data import synth as jsynth
from gradient_sdf_tpu.models.grad_sdf import GradSdfMap as JMap
from gradient_sdf_tpu.ops import fusion as jfu
from gradient_sdf_tpu.ops import normals as jnorm
from gradient_sdf_tpu.ops import query as jq
from gradient_sdf_tpu.ops import voxel_grid as jvg
from gradient_sdf_tpu_torch.models.grad_sdf import GradSdfMap as TMap
from gradient_sdf_tpu_torch.ops import fusion as tfu
from gradient_sdf_tpu_torch.ops import normals as tnorm
from gradient_sdf_tpu_torch.ops import query as tq
from gradient_sdf_tpu_torch.ops import voxel_grid as tvg
from gradient_sdf_tpu_torch.utils import interop

from oracle import fuse_oracle

W, H = 64, 48
K = np.array([[52.5, 0, 31.5], [0, 52.5, 23.5], [0, 0, 1]], dtype=np.float32)
GCFG = GridConfig(voxel_size=0.02, num_blocks=2048)
FCFG = FusionConfig(trunc_voxels=5.0)
ATOL = 1e-5
WORLD = jsynth.SphereWorld(
    centers=jnp.asarray([[0.0, 0.0, 0.0], [0.35, 0.2, -0.1]], jnp.float32),
    radii=jnp.asarray([0.25, 0.15], jnp.float32),
)


@pytest.fixture(scope="module")
def frames():
    """[(depth, R, t)] as numpy: 3 frames of an orbit, rendered once."""
    out = []
    for R, t in jsynth.orbit_poses(n=8, radius=1.5)[:3]:
        d = jsynth.render_depth(WORLD, jnp.asarray(R), jnp.asarray(t), K, W, H)
        out.append((np.array(d), R, t))
    return out


@pytest.fixture(scope="module")
def caches():
    return jnorm.build_cache(W, H, K, window=5), tnorm.build_cache(W, H, K, window=5)


@pytest.fixture(autouse=True)
def same_normals(monkeypatch):
    """JAX fusion takes the port's normals (see the module docstring); all
    frames here use the camera K."""

    def port_normals(cache, depth):
        tc = tnorm.build_cache(depth.shape[1], depth.shape[0], K,
                               window=cache.window)

        def host(d):
            return tnorm.compute_normals(tc, torch.from_numpy(np.array(d))).numpy()

        # a host callback, so it also runs inside the JAX map's jit
        return jax.pure_callback(
            host, jax.ShapeDtypeStruct(tuple(depth.shape) + (3,), jnp.float32),
            depth)

    monkeypatch.setattr(jfu, "compute_normals", port_normals)


def _fuse_both(frames, caches, fcfg, gcfg=GCFG, **kw):
    jc, tc = caches
    jg, tg = jvg.create(gcfg), tvg.create(gcfg)
    for depth, R, t in frames:
        jg = jfu.fuse_frame(jg, jnp.asarray(depth), jc, jnp.asarray(R),
                            jnp.asarray(t), gcfg, fcfg, **kw)
        tg = tfu.fuse_frame(tg, torch.from_numpy(depth), tc, torch.from_numpy(R),
                            torch.from_numpy(t), gcfg, fcfg, **kw)
    return jg, tg


def _assert_same_map(jg, tg, atol=ATOL):
    a = interop.grid_to_numpy(tg)
    b = {k: np.asarray(v) for k, v in jg._asdict().items()}
    for k in ("directory", "coarse_occ", "num_active", "overflow",
              "oob_samples", "block_coords"):
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    np.testing.assert_allclose(a["weight"], b["weight"], atol=atol)
    for k in ("dist", "grad_x", "grad_y", "grad_z"):
        np.testing.assert_allclose(a[k], b[k], atol=atol, err_msg=k)


VARIANTS = {
    "default": FCFG,
    "stride2": dataclasses.replace(FCFG, fusion_stride=2),
    "cosine": dataclasses.replace(FCFG, cosine_correction=True),
    "median": dataclasses.replace(FCFG, median_blur_depth=True),
}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_fuse_frame_matches_jax(frames, caches, variant):
    jg, tg = _fuse_both(frames, caches, VARIANTS[variant])
    assert int(tg.num_active) > 10
    _assert_same_map(jg, tg)


def test_later_frames_claim_blocks_in_jax_slot_order(frames, caches):
    """Frame 2 claims blocks frame 1 did not: the claim's slot ids (one pass
    over all compacted rays here, fixed-size chunks in the JAX package)
    must come out identical."""
    jg1, tg1 = _fuse_both(frames[:1], caches, FCFG)
    jg, tg = _fuse_both(frames, caches, FCFG)
    assert int(tg.num_active) > int(tg1.num_active)
    na = int(jg.num_active)
    np.testing.assert_array_equal(tg.block_coords[:na].numpy(),
                                  np.asarray(jg.block_coords[:na]))
    # and the JAX package's chunked walk (small chunks) agrees too
    jchunk, _ = _fuse_both(frames, caches,
                           dataclasses.replace(FCFG, compact_chunk_rays=256))
    np.testing.assert_array_equal(tg.block_coords[:na].numpy(),
                                  np.asarray(jchunk.block_coords[:na]))


def test_fuse_without_gradients_matches_jax(frames, caches):
    jg, tg = _fuse_both(frames[:2], caches, FCFG, accumulate_gradients=False)
    _assert_same_map(jg, tg)
    assert not tg.grad_x.any()


def test_fuse_matches_oracle_on_two_frames(frames, caches):
    _, tc = caches
    tg = tvg.create(GCFG)
    state = None
    for fid, (depth, R, t) in enumerate(frames[:2]):
        nrm = tnorm.compute_normals(tc, torch.from_numpy(depth)).numpy()
        tg = tfu.fuse_frame(tg, torch.from_numpy(depth), tc, torch.from_numpy(R),
                            torch.from_numpy(t), GCFG, FCFG)
        state = fuse_oracle(depth, nrm, tc.x0.numpy(), tc.y0.numpy(),
                            tc.n_sq_inv.numpy(), R, t, GCFG.voxel_size,
                            FCFG.trunc_voxels * GCFG.voxel_size, state=state,
                            frame_id=fid)
    assert len(state) > 100
    vox = np.array(list(state.keys()), dtype=np.int32)
    lin, present = tvg.lookup_voxels(tg, torch.from_numpy(vox), GCFG)
    assert bool(present.all())
    lin = lin.long()
    # oracle tolerances as tests/test_fusion.py: a sequential float64
    # running mean vs float32 accumulator sums
    np.testing.assert_allclose(tvg.flat_field(tg.weight)[lin].numpy(),
                               [state[tuple(v)]["weight"] for v in vox],
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tvg.flat_field(tg.dist)[lin].numpy(),
                               [state[tuple(v)]["dist"] for v in vox],
                               rtol=1e-3, atol=2e-5)
    np.testing.assert_allclose(tvg.flat_field(tg.grad)[lin].numpy(),
                               [state[tuple(v)]["grad"] for v in vox],
                               rtol=1e-3, atol=1e-4)
    # no extra weight anywhere else
    total = sum(v["weight"] for v in state.values())
    assert abs(float(tg.weight.sum()) - total) < 1e-2 * max(1.0, total)


def test_visibility_bits_match_jax(frames, caches):
    jc, tc = caches
    depth, R, t = frames[0]
    jg, tg = jvg.create(GCFG), tvg.create(GCFG)
    jvis = jnp.zeros(tuple(jg.dist.shape) + (2,), jnp.uint32)
    tvis = torch.zeros(tuple(tg.dist.shape) + (2,), dtype=torch.int32)
    for kf in (33, -1, 31):   # word 1; not a keyframe; the sign bit of word 0
        jg, jvis = jfu.fuse_frame(jg, jnp.asarray(depth), jc, jnp.asarray(R),
                                  jnp.asarray(t), GCFG, FCFG, vis=jvis,
                                  kf_slot=jnp.int32(kf))
        tg, tvis = tfu.fuse_frame(tg, torch.from_numpy(depth), tc,
                                  torch.from_numpy(R), torch.from_numpy(t),
                                  GCFG, FCFG, vis=tvis, kf_slot=kf)
    np.testing.assert_array_equal(tvis.numpy().view(np.uint32), np.asarray(jvis))
    assert np.asarray(jvis).any()


def test_map_growth_matches_jax(frames):
    """GradSdfMap grows capacity on overflow and the directory's world range
    on out-of-range samples, as the JAX map does: same growth events, same
    final map."""
    cfg = jcfg_mod.PipelineConfig()
    cfg = dataclasses.replace(cfg, grid=dataclasses.replace(
        cfg.grid, voxel_size=0.02, num_blocks=16, dir_dim=8))
    far = jsynth.SphereWorld(centers=jnp.asarray([[0.0, 0.0, 1.0]], jnp.float32),
                             radii=jnp.asarray([0.3], jnp.float32))
    R, t = np.eye(3, dtype=np.float32), np.zeros(3, np.float32)
    depth = np.array(jsynth.render_depth(far, jnp.asarray(R), jnp.asarray(t),
                                           K, W, H))
    jm, tm = JMap(cfg), TMap(cfg)
    for _ in range(3):
        jm.update(jnp.asarray(depth), K, (jnp.asarray(R), jnp.asarray(t)))
        tm.update(depth, K, (R, t))
    assert tm.growth_events == jm.growth_events
    assert {e["kind"] for e in tm.growth_events} == {"capacity", "world_range"}
    assert tm.cfg.grid == jm.cfg.grid
    _assert_same_map(jm.grid, tm.grid)


def _fuse_torch(frames, tc, acc=None, **kw):
    tg = tvg.create(GCFG)
    for depth, R, t in frames:
        tg = tfu.fuse_frame(tg, torch.from_numpy(depth), tc, torch.from_numpy(R),
                            torch.from_numpy(t), GCFG, FCFG, acc=acc, **kw)
    return tg


def _assert_same_bits(a, b):
    da, db = interop.grid_to_numpy(a), interop.grid_to_numpy(b)
    assert da.keys() == db.keys()
    for k in da:
        np.testing.assert_array_equal(da[k], db[k], err_msg=k)


@pytest.mark.parametrize("grads", [True, False])
def test_callers_accumulator_equals_bare_calls_and_stays_zero(frames, caches,
                                                              grads):
    """One persistent accumulator carried over three frames gives the bits
    of three bare calls (each with its own fresh accumulator), and reads
    zero after every frame."""
    _, tc = caches
    bare = _fuse_torch(frames, tc, accumulate_gradients=grads)
    tg = tvg.create(GCFG)
    acc = tfu.new_accumulator(tg)
    assert acc.shape == (GCFG.num_blocks * GCFG.voxels_per_block, 8)
    for depth, R, t in frames:
        tg = tfu.fuse_frame(tg, torch.from_numpy(depth), tc, torch.from_numpy(R),
                            torch.from_numpy(t), GCFG, FCFG, acc=acc,
                            accumulate_gradients=grads)
        assert not acc.any()
    _assert_same_bits(tg, bare)
    assert float(tg.weight.sum()) > 0


@pytest.mark.parametrize("with_vis", [False, True])
def test_map_accumulator_is_zero_after_update_and_equals_bare_fusion(
        frames, caches, with_vis):
    """Two frames fused through a map (persistent accumulator) equal two
    bare fuse_frame calls; the map's accumulator is all zero in between."""
    _, tc = caches
    cfg = jcfg_mod.PipelineConfig(grid=GCFG, fusion=dataclasses.replace(
        FCFG, normal_window=5))
    m = TMap(cfg, with_vis=with_vis)
    assert m.acc.shape == (GCFG.num_blocks * GCFG.voxels_per_block, 8)
    for depth, R, t in frames[:2]:
        m.update(depth, K, (R, t), kf_slot=3)
        assert not m.acc.any()
    _assert_same_bits(m.grid, _fuse_torch(frames[:2], tc))
    if with_vis:
        assert m.vis.any()


def test_map_growth_grows_the_accumulator():
    cfg = jcfg_mod.PipelineConfig()
    cfg = dataclasses.replace(cfg, grid=dataclasses.replace(
        cfg.grid, voxel_size=0.02, num_blocks=16, dir_dim=8))
    far = jsynth.SphereWorld(centers=jnp.asarray([[0.0, 0.0, 1.0]], jnp.float32),
                             radii=jnp.asarray([0.3], jnp.float32))
    R, t = np.eye(3, dtype=np.float32), np.zeros(3, np.float32)
    depth = np.array(jsynth.render_depth(far, jnp.asarray(R), jnp.asarray(t),
                                           K, W, H))
    m = TMap(cfg)
    rows0 = m.acc.shape[0]
    for _ in range(3):   # overflow and out-of-range frames, then a clean one
        m.update(depth, K, (R, t))
        assert not m.acc.any()
    assert any(e["kind"] == "capacity" for e in m.growth_events)
    nvox = m.grid.num_blocks * m.grid.voxels_per_block
    assert nvox > rows0
    assert m.acc.shape == (nvox, 8) and not m.acc.any()
    assert int(m.grid.num_active) > 16


def test_block_slots_are_handed_out_contiguously_from_zero(frames, caches):
    """merge_clear walks the slots [0, num_active): the directory must hold
    exactly those slot ids, and no voxel past them may carry state."""
    _, tc = caches
    for upto in (1, 2, 3):
        tg = _fuse_torch(frames[:upto], tc)
        na = int(tg.num_active)
        slots = tg.directory[tg.directory >= 0]
        np.testing.assert_array_equal(np.sort(slots.numpy()), np.arange(na))
        for name in ("weight", "dist", "grad_x", "grad_y", "grad_z"):
            assert not getattr(tg, name)[na:].any(), name
        assert not tg.block_coords[na:].any()
        # every slot below num_active was written by the frames
        assert bool((tg.weight[:na].sum(dim=1) > 0).all())


def test_fuse_frame_rejects_an_accumulator_of_another_grid(frames, caches):
    _, tc = caches
    depth, R, t = frames[0]
    tg = tvg.create(GCFG)
    small = tfu.new_accumulator(tvg.create(dataclasses.replace(GCFG, num_blocks=8)))
    with pytest.raises(ValueError):
        tfu.fuse_frame(tg, torch.from_numpy(depth), tc, torch.from_numpy(R),
                       torch.from_numpy(t), GCFG, FCFG, acc=small)


def test_tsdf_grad_and_weights_match_jax(frames, caches):
    jg, tg = _fuse_both(frames[:2], caches, FCFG)
    rng = np.random.default_rng(12)
    # points within half a voxel of observed voxels, and some anywhere
    # (mostly absent from the map)
    m = TMap(jcfg_mod.PipelineConfig(grid=GCFG, fusion=FCFG))
    m.grid = tg
    vox, _, weight, _ = m.occupied()
    near = vox[weight > 0][rng.integers(0, int((weight > 0).sum()), 3000)]
    pts = np.concatenate([
        (near + rng.uniform(-0.5, 0.5, near.shape)) * GCFG.voxel_size,
        rng.uniform(-0.45, 0.45, size=(1000, 3))]).astype(np.float32)
    jphi, jgrad, jw = jq.tsdf_grad(jg, jnp.asarray(pts), GCFG, FCFG)
    tphi, tgrad, tw = tq.tsdf_grad(tg, torch.from_numpy(pts), GCFG, FCFG)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=1e-5)
    assert (tw.numpy() > 0).sum() > 2000
    # phi: dist + 1.2 ghat.(c - p) with |c - p| < 0.5 voxel; the gradient
    # is normalized, so its ~1e-5 sum difference divides by |g| >= ~0.5
    np.testing.assert_allclose(tphi.numpy(), np.asarray(jphi), atol=1e-5)
    np.testing.assert_allclose(tgrad.numpy(), np.asarray(jgrad), atol=1e-4)
    np.testing.assert_allclose(
        tq.weights_at(tg, torch.from_numpy(pts), GCFG).numpy(),
        np.asarray(jq.weights_at(jg, jnp.asarray(pts), GCFG)), atol=1e-5)
