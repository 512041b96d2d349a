"""Fusion's integrate kernel (gradient_sdf_tpu_torch/ops/kernels/
fuse_integrate.py): its plain versions, which are the CPU path of
`fusion.fuse_frame` and the card kernel's oracle, against the JAX
package's `fuse_frame`.

Frames: tests/test_torch_fusion.py's three orbit frames of two spheres at
its 64x48 camera, with depth noise from a numpy seed on the hit pixels (so
later frames claim blocks the first did not), handed to both packages as
numpy arrays; the JAX fusion takes the port's normals (that file's
`same_normals` fixture, see its docstring). Each frame goes through the
port's steps by hand: `claim_pass`, `fusion.claim_blocks`,
`integrate_merge`. The CUDA kernel itself is held to these plain versions
by the `gpu`-marked tests (skipped without a card) and by `chip_smoke.py`
phase 3b.

Tolerances, with their reasons:
  * structure (directory, coarse occupancy, block coordinates, block
    count, overflow, oob counter, candidates, visibility words): exact —
    same gates, same (pixel, k) candidate order;
  * weight, dist, grad: atol 1e-5 (test_torch_fusion.py's ATOL) — float32
    sums of <= ~30 samples per voxel in another order;
  * the merge over the touched blocks against `merge_clear`'s plain
    version on those rows: bit equality (the same operations).
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from gradient_sdf_tpu.config import FusionConfig, GridConfig, PipelineConfig
from gradient_sdf_tpu.ops import fusion as jfu
from gradient_sdf_tpu.ops import voxel_grid as jvg
from gradient_sdf_tpu_torch.models.grad_sdf import GradSdfMap as TMap
from gradient_sdf_tpu_torch.ops import fusion as tfu
from gradient_sdf_tpu_torch.ops import normals as tnorm
from gradient_sdf_tpu_torch.ops import voxel_grid as tvg
from gradient_sdf_tpu_torch.ops.kernels import fuse_integrate as fi
from gradient_sdf_tpu_torch.ops.kernels import merge_clear as mc
from gradient_sdf_tpu_torch.ops.kernels import scatter_add as sa
from gradient_sdf_tpu_torch.tools import fusion_bench as fb
from gradient_sdf_tpu_torch.utils import interop

from test_torch_fusion import (ATOL, FCFG, GCFG, H, K, W, _assert_same_map,  # noqa: F401
                               caches, frames, same_normals)

NOISE_SEED = 11


@pytest.fixture(scope="module")
def noisy(frames):
    """The three frames with 2 mm of seeded noise on the hit pixels."""
    rng = np.random.default_rng(NOISE_SEED)
    out = []
    for d, R, t in frames:
        n = rng.normal(0.0, 2e-3, d.shape).astype(np.float32)
        out.append((np.where(d > 0, d + n, d).astype(np.float32), R, t))
    return out


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _steps(tg, tc, depth, R, t, gcfg, fcfg, acc, **kw):
    """One frame through the port's steps on the CPU (fuse_frame's body)."""
    nrm = tnorm.compute_normals(tc, depth).contiguous()
    status, mark, keys = fi.claim_pass(depth, nrm, tc, R, t, tg, gcfg, fcfg)
    misses, oob = status.tolist()
    tg = tfu.claim_blocks(tg, mark, keys, misses, oob, gcfg)
    fi.integrate_merge(depth, nrm, tc, R, t, tg, gcfg, fcfg, acc, **kw)
    return tg, misses, oob


def _both(noisy, caches, fcfg=FCFG, gcfg=GCFG, vis_words=None, kf=None,
          **kw):
    jc, tc = caches
    jg, tg = jvg.create(gcfg), tvg.create(gcfg, "cpu")
    acc = tfu.new_accumulator(tg)
    jvis = tvis = None
    if vis_words:
        jvis = jnp.zeros(tuple(jg.dist.shape) + (vis_words,), jnp.uint32)
        tvis = torch.zeros(tuple(tg.dist.shape) + (vis_words,),
                           dtype=torch.int32)
    claims = []
    for i, (d, R, t) in enumerate(noisy):
        slot = None if kf is None else kf[i]
        jkw = dict(kw)
        if jvis is not None:
            jkw.update(vis=jvis, kf_slot=jnp.int32(slot))
        out = jfu.fuse_frame(jg, jnp.asarray(d), jc, jnp.asarray(R),
                             jnp.asarray(t), gcfg, fcfg, **jkw)
        jg, jvis = out if jvis is not None else (out, None)
        tg, misses, oob = _steps(tg, tc, _t(d), _t(R), _t(t), gcfg, fcfg, acc,
                                 vis=tvis, kf_slot=slot, **kw)
        claims.append((misses, oob))
        assert not acc.any()
    return jg, tg, jvis, tvis, claims


VARIANTS = {
    "default": (FCFG, {}),
    "no_gradients": (FCFG, {"accumulate_gradients": False}),
    "stride2": (dataclasses.replace(FCFG, fusion_stride=2), {}),
    "cosine": (dataclasses.replace(FCFG, cosine_correction=True), {}),
}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_plain_passes_match_jax_fuse_frame(noisy, caches, variant):
    """Every frame claims blocks (the later ones blocks the first did not)
    in the JAX package's slot order; the fields agree; the accumulator is
    zero after every frame."""
    fcfg, kw = VARIANTS[variant]
    jg, tg, _, _, claims = _both(noisy, caches, fcfg, **kw)
    assert all(m > 0 for m, _ in claims)
    assert int(tg.num_active) > 10
    _assert_same_map(jg, tg)
    if kw.get("accumulate_gradients") is False:
        assert not tg.grad_x.any()


def test_keyframe_bits_match_jax(noisy, caches):
    """A keyframe slot in word 1, no keyframe, then bit 31 of word 0."""
    jg, tg, jvis, tvis, _ = _both(noisy, caches, vis_words=2, kf=(33, -1, 31))
    _assert_same_map(jg, tg)
    np.testing.assert_array_equal(tvis.numpy().view(np.uint32), np.asarray(jvis))
    assert np.asarray(jvis)[..., 1].any() and (np.asarray(jvis)[..., 0] >> 31).any()


def test_capacity_overflow_matches_jax(noisy, caches):
    """A 12-block grid: claims past the capacity are dropped (the overflow
    flag set), and their samples with them, as in the JAX package."""
    gcfg = dataclasses.replace(GCFG, num_blocks=12)
    jg, tg, _, _, _ = _both(noisy, caches, gcfg=gcfg)
    assert bool(tg.overflow) and int(tg.num_active) == 12
    _assert_same_map(jg, tg)


def test_oob_samples_match_jax(noisy, caches):
    """A directory of 4^3 blocks (+-32 cm at 2 cm voxels): live samples
    outside it are dropped and counted as in the JAX package."""
    gcfg = dataclasses.replace(GCFG, dir_dim=4)
    jg, tg, _, _, claims = _both(noisy, caches, gcfg=gcfg)
    assert all(o > 0 for _, o in claims)
    assert int(tg.oob_samples) == sum(o for _, o in claims)
    _assert_same_map(jg, tg)


def test_claim_candidates_are_the_jax_walks_missing_samples(noisy, caches):
    """`claim_pass` marks candidate pixel * K + k of the whole frame for
    exactly the live samples whose block the map lacks, with their keys:
    the JAX package's uncompacted walk (`_sample_frame`) looked up in the
    same map."""
    jc, tc = caches
    (d0, R0, t0), (d1, R1, t1) = noisy[:2]
    jg = jfu.fuse_frame(jvg.create(GCFG), jnp.asarray(d0), jc, jnp.asarray(R0),
                        jnp.asarray(t0), GCFG, FCFG)
    tg = interop.grid_from_numpy({k: np.asarray(v) for k, v in jg._asdict().items()})
    s = jfu._sample_frame(jnp.asarray(d1), jfu.compute_normals(jc, jnp.asarray(d1)),
                          jc, jnp.asarray(R1), jnp.asarray(t1), GCFG, FCFG)
    keys = np.asarray(s.keys)
    slot = np.asarray(jvg.lookup_keys(jg, s.keys, GCFG))
    want = np.flatnonzero((keys >= 0) & (slot < 0))
    assert want.size > 0
    nrm = tnorm.compute_normals(tc, _t(d1)).contiguous()
    status, mark, got = fi.claim_pass(_t(d1), nrm, tc, _t(R1), _t(t1), tg, GCFG,
                                      FCFG)
    assert status.dtype == torch.int32 and status.shape == (fi.STATUS,)
    assert status.tolist() == [want.size, int(s.oob)]
    assert mark.dtype == torch.uint8 and mark.shape == keys.shape
    np.testing.assert_array_equal(np.flatnonzero(mark.numpy()), want)
    np.testing.assert_array_equal(got.numpy()[want], keys[want])


def test_map_keeps_its_scratch_zero_and_sized(noisy):
    """`GradSdfMap` owns the kernel's scratch beside its accumulator: both
    stay zero between frames (bare fuse_frame calls give the same bits),
    and growth rebuilds them at the grown grid's block count."""
    cfg = PipelineConfig(grid=dataclasses.replace(GCFG, num_blocks=16),
                         fusion=dataclasses.replace(FCFG, normal_window=5))
    m = TMap(cfg, device="cpu")
    for d, R, t in noisy:
        m.update(d, K, (R, t))
        assert not m.acc.any() and not m.scratch.marks.any()
        assert m.scratch.marks.shape == (m.grid.num_blocks,)
    assert any(e["kind"] == "capacity" for e in m.growth_events)
    assert m.acc.shape == (m.grid.num_blocks * m.grid.voxels_per_block, 8)


def test_merge_over_touched_blocks_is_merge_clears_on_their_rows():
    """The integrate pass's merge of a set of blocks equals `merge_clear`'s
    plain version on those blocks' rows bit for bit and leaves every other
    row and the rest of the accumulator alone; the keyframe bit lands on
    exactly the rows with a weight sum."""
    rng = np.random.default_rng(5)
    gcfg = GridConfig(voxel_size=0.02, num_blocks=10, dir_dim=16)
    g = tvg.create(gcfg, "cpu")
    vpb = gcfg.voxels_per_block
    for k in ("weight", "dist", "grad_x", "grad_y", "grad_z"):
        getattr(g, k)[:6] = torch.from_numpy(
            rng.uniform(0.0, 9.0, (6, vpb)).astype(np.float32))
    acc = torch.zeros((10 * vpb, sa.ACC_ROW))
    blocks = torch.tensor([1, 4])
    rows = (blocks[:, None] * vpb + torch.arange(vpb)).reshape(-1)
    hit = rows[torch.from_numpy(rng.random(rows.numel()) < 0.4)]
    acc[hit, :5] = torch.from_numpy(rng.uniform(0.1, 3.0, (hit.numel(), 5)).astype(np.float32))
    want = [getattr(g, k).clone() for k in ("weight", "dist", "grad_x", "grad_y", "grad_z")]
    acc_w = acc.clone()
    mc.merge_clear_reference(acc_w, *want, torch.tensor(10, dtype=torch.int32))
    vis = torch.zeros((10, vpb, 1), dtype=torch.int32)
    before = [getattr(g, k).clone() for k in ("weight", "dist", "grad_x", "grad_y", "grad_z")]
    fi.merge_blocks_reference(acc, g, blocks, with_grad=True, vis=vis, kf=(0, 31))
    for k, w, b in zip(("weight", "dist", "grad_x", "grad_y", "grad_z"), want, before):
        got = getattr(g, k)
        assert torch.equal(got[blocks], w[blocks]), k
        keep = torch.ones(10, dtype=torch.bool)
        keep[blocks] = False
        assert torch.equal(got[keep], b[keep]), k
    assert not acc.any()
    marked = vis.view(-1) != 0
    assert torch.equal(torch.nonzero(marked).reshape(-1), torch.sort(hit).values)
    assert int(vis.view(-1)[hit[0]]) == -2**31


def test_wrappers_on_cpu_count_no_launch_and_check_inputs(noisy, caches):
    _, tc = caches
    d, R, t = (_t(a) for a in noisy[0])
    tg = tvg.create(GCFG, "cpu")
    nrm = tnorm.compute_normals(tc, d).contiguous()
    acc = tfu.new_accumulator(tg)
    fi.reset_launch_count()
    fi.claim_pass(d, nrm, tc, R, t, tg, GCFG, FCFG)
    fi.integrate_merge(d, nrm, tc, R, t, tg, GCFG, FCFG, acc)
    assert fi.launch_count == fi.claim_launch_count == 0
    with pytest.raises(ValueError, match="depth"):
        fi.claim_pass(d.double(), nrm, tc, R, t, tg, GCFG, FCFG)
    with pytest.raises(ValueError, match="normals"):
        fi.claim_pass(d, nrm[:, :, :2], tc, R, t, tg, GCFG, FCFG)
    with pytest.raises(ValueError, match="R"):
        fi.integrate_merge(d, nrm, tc, R.t(), t, tg, GCFG, FCFG, acc)
    with pytest.raises(ValueError, match="acc"):
        fi.integrate_merge(d, nrm, tc, R, t, tg, GCFG, FCFG, acc[:, :5])
    with pytest.raises(ValueError, match="vis"):
        fi.integrate_merge(d, nrm, tc, R, t, tg, GCFG, FCFG, acc,
                           vis=torch.zeros((3, 2, 1), dtype=torch.int32),
                           kf_slot=0)
    # a device with no kernel and no plain path: raise, never fall back
    meta = [a.to("meta") for a in (d, nrm, R, t)]
    mc_ = tnorm.NormalEstimatorCache(*(a.to("meta") if torch.is_tensor(a) else a
                                       for a in tc))
    mg = type(tg)(*(a.to("meta") for a in tg))
    with pytest.raises(RuntimeError, match="no kernel"):
        fi.claim_pass(meta[0], meta[1], mc_, meta[2], meta[3], mg, GCFG, FCFG)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["default", "keyframe", "no_gradients",
                                  "stride2", "cosine", "overflow", "oob"])
def test_cuda_kernel_matches_plain_passes(noisy, case):
    """On a card: the kernel's claims, slots, directory, coarse occupancy,
    block coordinates, block count, overflow, oob and visibility words
    equal its plain versions' bit for bit, the fields within ATOL, the
    accumulator and marks zero (`fusion_bench.kernel_vs_twin`)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    fcfg = dataclasses.replace(FCFG, normal_window=5)
    gcfg, kw = GCFG, {}
    if case == "keyframe":
        kw = {"kf_slot": 33}
    elif case == "no_gradients":
        kw = {"accumulate_gradients": False}
    elif case == "stride2":
        fcfg = dataclasses.replace(fcfg, fusion_stride=2)
    elif case == "cosine":
        fcfg = dataclasses.replace(fcfg, cosine_correction=True)
    elif case == "overflow":
        gcfg = dataclasses.replace(GCFG, num_blocks=12)
    elif case == "oob":
        gcfg = dataclasses.replace(GCFG, dir_dim=4)
    cfg = PipelineConfig(grid=gcfg, fusion=fcfg)
    fi.reset_launch_count()
    r = fb.kernel_vs_twin(cfg, [d for d, _, _ in noisy],
                          [(R, t) for _, R, t in noisy], K,
                          torch.device("cuda"),
                          {"weight": ATOL, "dist": ATOL, "grad": ATOL}, **kw)
    assert fi.launch_count == fi.claim_launch_count == len(noisy)
    assert r["frames"] == len(noisy) and r["misses"] > 0
    assert r["overflow"] == (case == "overflow")
    assert (r["oob"] > 0) == (case == "oob")


@pytest.mark.gpu
def test_cuda_fuse_frame_is_two_launches_and_one_sync(noisy):
    """On a card a fused frame launches the claim pass and the integrate
    pass once each, neither the scatter kernel nor merge_clear, and waits
    for the device once (the claim's status) plus `insert_new`'s own waits
    on a frame that opens blocks."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    cfg = PipelineConfig(grid=GCFG, fusion=dataclasses.replace(
        FCFG, normal_window=5))
    m = TMap(cfg, device="cuda")
    m.update(noisy[0][0], K, noisy[0][1:])
    d, R, t = (_t(a).cuda() for a in noisy[1])
    before = int(m.grid.num_active)
    opened = fb.count_fuse_frame(m, d, R, t)
    assert int(m.grid.num_active) > before
    again = fb.count_fuse_frame(m, d, R, t)
    for c in (opened, again):
        assert (c["claim"], c["integrate"], c["scatter_add"],
                c["merge_clear"]) == (1, 1, 0, 0)
        assert c["status_syncs"] == 1 and c["other_syncs"] == 0
    assert opened["insert_syncs"] > 0 and again["insert_syncs"] == 0
