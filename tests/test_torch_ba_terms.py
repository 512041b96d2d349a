"""PhotoBA's per-(voxel, frame) pass (`ops/kernels/ba_terms`): the plain
versions against the JAX package on the CPU, and the CUDA kernels
(`csrc/ba_terms.cu`) against the plain versions on a card.

The CPU tests feed the fixtures of `test_torch_photo_ba.py` (a textured
plane seen by 3 cameras; an unstructured problem with points behind the
cameras, voxels no frame sees (n == 0) and 50 padding rows) through both
packages, with `loss` "cauchy" (the default: plain L2 in the solvers) and
"trunc_l2", and `channel_mix_parity` off and on; and the shapes the
kernels' tiling makes (`_tiling_arrays`: 1, 33 and 70 frames, one, two and
three chunks of 32, over 301 voxels, a count no CTA or warp divides, on
40x30 images). Tolerances, with their reasons (those of
`test_torch_photo_ba.py`):
  * energy, rtol 1e-4: sum|A|^2 - |sum A|^2/N cancels in float32, and the
    two packages sum in other orders;
  * dist, atol 1e-6 + rtol 1e-4: one b/H step of the same float32 sums;
  * n exactly (counts of the same gated pairs); mean intensity 1e-5: the
    JAX package projects with a matrix product, whose rounding moves u by
    up to ~4e-6 pixel, and the random fixture's noise images change by ~1
    a pixel;
  * H and b, 1e-4 of their largest entry (sums over 3V rows).

On a card (`gpu` marker; skipped here): each kernel against its plain
version on the same card, with the acceptance tolerances of the port:
energies rtol 1e-5 (the same pairs, summed in another order); dist to
atol 1e-6 + rtol 1e-4, where at most a 1e-3 share of the voxels may miss
(a product that the plain version leaves to a library call may round one
pair's u across a pixel edge, which moves that voxel's step); n exactly;
H and b to 1e-4 of their largest entry per frame; two runs bit-equal.
"""

import ctypes
import dataclasses
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gradient_sdf_tpu.models import photo_ba as jba
from gradient_sdf_tpu_torch.models import photo_ba as tba
from gradient_sdf_tpu_torch.ops.kernels import _build
from gradient_sdf_tpu_torch.ops.kernels import ba_terms as bt
from gradient_sdf_tpu_torch.utils import interop
from gradient_sdf_tpu_torch.utils import se3 as tse3
from test_torch_photo_ba import (FIXTURES, GCFG, LOSSES, PCFG, _both,  # noqa: F401
                                 _jax_pose_system, _pcfg, _random_arrays)

MIX = [False, True]
# frames of the tiling shapes: one chunk of 32 frames, two, three
TILING_FRAMES = [1, 33, 70]
# the tiling shapes on the card, (frames, path): a launch of at most 8
# frames over at most a warp a scheduler (16,896 voxels on 132 SMs) takes
# the dense paths, any other the full-card ones; each card test checks its
# path. PATH_VOXELS: the voxels of each path's shapes
CARD_SHAPES = [(1, "dense"), (8, "dense"), (1, "full card"),
               (33, "full card"), (70, "full card")]
PATH_VOXELS = {"dense": 301, "full card": 20011}
# the card's tolerances (module note)
CARD_E_RTOL = 1e-5
CARD_DIST_ATOL, CARD_DIST_RTOL, CARD_OUTLIERS = 1e-6, 1e-4, 1e-3
SYS_RTOL = 1e-4


def _shifted(fixture):
    """The fixture with every dist moved by 4 mm, so that the dist step is
    real and some voxels leave the |dist| <= voxel_size gate."""
    problem, state = FIXTURES[fixture]()
    state["dist"] = state["dist"] + np.float32(0.004)
    return problem, state


# ---------------------------------------------------------------------------
# CPU: the plain versions against the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fixture", sorted(FIXTURES))
def test_energy_reference_matches_jax(fixture):
    arrays = _shifted(fixture)
    (jp, js), (tp, ts) = _both(arrays)
    want = float(jba.energy(jp, js, GCFG))
    got = bt.ba_voxel_sums_reference(tp, ts, GCFG, None, "energy")
    assert got.dim() == 0 and got.dtype == torch.float32 and want > 1e-3
    np.testing.assert_allclose(float(got), want, rtol=1e-4)
    # the wrapper takes it on the CPU, and launches nothing
    bt.reset_launch_count()
    assert torch.equal(tba.energy(tp, ts, GCFG), got)
    assert bt.launch_count == bt.pose_launch_count == 0


def test_energy_ignores_padding_and_unseen_voxels():
    """Padding rows and voxels no frame sees add nothing: scrambling their
    voxels, gradients and dists leaves the energy's bits as they were."""
    problem, state = _random_arrays()
    _, (tp, ts) = _both((problem, state))
    e0 = bt.ba_voxel_sums_reference(tp, ts, GCFG, None, "energy")
    rng = np.random.RandomState(12)
    off = ~problem["vmask"] | ~problem["vis"].any(axis=1)
    assert off.sum() >= 70
    p2 = dict(problem, vox=problem["vox"].copy(), grad=problem["grad"].copy())
    s2 = dict(state, dist=state["dist"].copy())
    p2["vox"][off] = rng.randint(-5, 5, (off.sum(), 3))
    p2["grad"][off] = rng.randn(off.sum(), 3)
    s2["dist"][off] = 0.0
    _, (tp2, ts2) = _both((p2, s2))
    assert torch.equal(bt.ba_voxel_sums_reference(tp2, ts2, GCFG, None,
                                                  "energy"), e0)


@pytest.mark.parametrize("mix", MIX)
@pytest.mark.parametrize("loss", LOSSES)
@pytest.mark.parametrize("fixture", sorted(FIXTURES))
def test_dist_reference_matches_jax(fixture, loss, mix):
    problem, state = arrays = _shifted(fixture)
    (jp, js), (tp, ts) = _both(arrays)
    pcfg = _pcfg(loss, channel_mix_parity=mix)
    want = np.asarray(jba.solve_dist(jp, js, GCFG, pcfg).dist)
    got = bt.ba_voxel_sums_reference(tp, ts, GCFG, pcfg, "dist")
    assert got.shape == ts.dist.shape
    assert np.abs(want - state["dist"]).max() > 1e-4  # the step is real
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=1e-4)
    # padding rows and voxels no frame sees (n == 0) do not move
    still = ~problem["vmask"] | ~problem["vis"].any(axis=1)
    np.testing.assert_array_equal(got.numpy()[still], state["dist"][still])
    assert torch.equal(tba.solve_dist(tp, ts, GCFG, pcfg).dist, got)


@pytest.mark.parametrize("loss", LOSSES)
@pytest.mark.parametrize("fixture", sorted(FIXTURES))
def test_mean_reference_matches_jax(fixture, loss):
    problem, _ = arrays = _shifted(fixture)
    (jp, js), (tp, ts) = _both(arrays)
    pcfg = _pcfg(loss)
    _, jn, _, jmean, _ = jba._pose_terms(jp, js, GCFG, pcfg)
    n, mean = bt.ba_voxel_sums_reference(tp, ts, GCFG, pcfg, "mean")
    assert n.dtype == mean.dtype == torch.float32 and mean.shape == (len(n), 3)
    np.testing.assert_array_equal(n.numpy(), np.asarray(jn))
    np.testing.assert_allclose(mean.numpy(), np.asarray(jmean), atol=1e-5)
    assert (n.numpy() > 0).any()
    # the gate: n is 0 off the |dist| <= voxel_size band, on padding rows
    # and where no frame sees the voxel (the random fixture has all three);
    # their mean is 0
    off = (~problem["vmask"] | ~problem["vis"].any(axis=1)
           | (np.abs(ts.dist.numpy()) > GCFG.voxel_size))
    assert off.any() == (fixture == "random")
    assert (n.numpy()[off] == 0).all() and (mean.numpy()[off] == 0).all()


@pytest.mark.parametrize("mix", MIX)
@pytest.mark.parametrize("loss", LOSSES)
@pytest.mark.parametrize("fixture", sorted(FIXTURES))
def test_pose_systems_reference_matches_jax(fixture, loss, mix):
    (jp, js), (tp, ts) = _both(FIXTURES[fixture]())
    pcfg = _pcfg(loss, channel_mix_parity=mix)
    Hj, bj = _jax_pose_system(jp, js, pcfg)
    n, mean = bt.ba_voxel_sums_reference(tp, ts, GCFG, pcfg, "mean")
    H, b = bt.ba_pose_systems_reference(tp, ts, GCFG, pcfg, n, mean)
    F = tp.images.shape[0]
    assert H.shape == (F, 6, 6) and b.shape == (F, 6)
    assert np.abs(Hj).max() > 0 and np.abs(bj).max() > 0
    np.testing.assert_allclose(H.numpy(), Hj, atol=1e-4 * np.abs(Hj).max())
    np.testing.assert_allclose(b.numpy(), bj, atol=1e-4 * np.abs(bj).max())
    # `pose_systems` is the two wrappers, which take the plain versions here
    Hw, bw = tba.pose_systems(tp, ts, GCFG, pcfg)
    assert torch.equal(Hw, H) and torch.equal(bw, b)


def _tiling_arrays(F, V=301, seed=21, W=40, H=30):
    """An unstructured problem at the shapes the kernels' tiling makes:
    F frames of W x H images, V voxels (no multiple of 32); some voxels
    behind the cameras, some no frame sees, padding rows (vmask off) and
    dists beyond one voxel."""
    rng = np.random.RandomState(seed + F)
    K = np.array([[36.0, 0.0, (W - 1) / 2], [0.0, 36.0, (H - 1) / 2],
                  [0.0, 0.0, 1.0]], np.float32)
    vox = np.concatenate([rng.randint(-12, 12, (V, 2)),
                          rng.randint(30, 70, (V, 1))], 1).astype(np.int32)
    vox[:9, 2] = -5  # behind the cameras
    vmask = np.arange(V) < V - 23
    vis = rng.rand(V, F) < 0.6
    vis[40:55] = False
    problem = dict(
        vox=vox, grad=rng.randn(V, 3).astype(np.float32),
        weight=rng.uniform(1, 20, V).astype(np.float32), vmask=vmask, vis=vis,
        images=rng.rand(F, H, W, 3).astype(np.float32), K=K)
    dist = rng.uniform(-0.03, 0.03, V).astype(np.float32)
    R = np.stack([tse3.so3_exp(torch.from_numpy(
        rng.randn(3).astype(np.float32) * 0.02)).numpy() for _ in range(F)])
    state = dict(dist=dist, R=R.astype(np.float32),
                 t=rng.uniform(-0.05, 0.05, (F, 3)).astype(np.float32))
    return problem, state


@pytest.mark.parametrize("mix", MIX)
@pytest.mark.parametrize("loss", LOSSES)
@pytest.mark.parametrize("F", TILING_FRAMES)
def test_references_match_jax_at_tiling_shapes(F, loss, mix):
    """Every plain version against the JAX package at 1, 33 and 70 frames
    (module note's tolerances)."""
    problem, state = arrays = _tiling_arrays(F)
    (jp, js), (tp, ts) = _both(arrays)
    pcfg = _pcfg(loss, channel_mix_parity=mix)
    off = (~problem["vmask"] | ~problem["vis"].any(axis=1)
           | (np.abs(state["dist"]) > GCFG.voxel_size))
    assert off.any() and (np.abs(state["dist"]) > GCFG.voxel_size).any()
    # energy
    want = float(jba.energy(jp, js, GCFG))
    got = bt.ba_voxel_sums_reference(tp, ts, GCFG, pcfg, "energy")
    # one frame: every pair is its voxel's mean, and the energy is the
    # float32 residue of sum|A|^2 - |sum A|^2 / N, ~1e-8 a voxel
    assert want > 1e-3 or F == 1
    np.testing.assert_allclose(float(got), want, rtol=1e-4, atol=1e-5)
    # dist
    dist = bt.ba_voxel_sums_reference(tp, ts, GCFG, pcfg, "dist")
    np.testing.assert_allclose(dist.numpy(),
                               np.asarray(jba.solve_dist(jp, js, GCFG, pcfg).dist),
                               atol=1e-6, rtol=1e-4)
    still = ~problem["vmask"] | ~problem["vis"].any(axis=1)
    np.testing.assert_array_equal(dist.numpy()[still], state["dist"][still])
    # n and the mean intensity
    frame_AJ, jn, inv_n, jmean, _ = jba._pose_terms(jp, js, GCFG, pcfg)
    n, mean = bt.ba_voxel_sums_reference(tp, ts, GCFG, pcfg, "mean")
    np.testing.assert_array_equal(n.numpy(), np.asarray(jn))
    np.testing.assert_allclose(mean.numpy(), np.asarray(jmean), atol=1e-5)
    assert (n.numpy()[off] == 0).all() and (n.numpy() > 0).any()
    # the pose systems, from the JAX package's per-frame pass mapped over
    # the frames at once
    A, Jc, valid = jax.vmap(frame_AJ)(js.R, js.t, jp.images, jp.vis.T)
    w = (valid & (jn > 0)).astype(jnp.float32)
    bj = np.asarray(jnp.einsum("fv,fvc,fvce->fe", w, A - jmean, Jc,
                               precision="highest"))
    Hj = np.asarray(jnp.einsum("fv,fvce,fvcg->feg", w * (1.0 - inv_n), Jc, Jc,
                               precision="highest"))
    H, b = bt.ba_pose_systems_reference(tp, ts, GCFG, pcfg, n, mean)
    assert H.shape == (F, 6, 6) and b.shape == (F, 6)
    if F == 1:
        # n = 1: (1 - 1/n) = 0 and A - mean = 0, so H and b are zero; the
        # JAX package's are the noise of its two projections of A
        assert not H.any() and not b.any()
        assert np.abs(Hj).max() < 1e-3 and np.abs(bj).max() < 1e-3
        return
    assert np.abs(Hj).max() > 0 and np.abs(bj).max() > 0
    np.testing.assert_allclose(H.numpy(), Hj, atol=1e-4 * np.abs(Hj).max())
    np.testing.assert_allclose(b.numpy(), bj, atol=1e-4 * np.abs(bj).max())


def test_bench_switches_match_the_kernel_source():
    """`ba_bench.BA_SWITCHES` knows the source's design and each switch's
    anchors are found exactly once as `fusion_bench.build_switched` applies
    its edits (in order), so that a stale switch fails here and not in a
    card run."""
    from gradient_sdf_tpu_torch.tools import ba_bench

    with open(os.path.join(_build.CSRC, "ba_terms.cu")) as f:
        text = f.read()
    designs = [d for d, (mark, _) in ba_bench.BA_SWITCHES.items()
               if mark in text]
    assert len(designs) == 1
    for name, edits in ba_bench.BA_SWITCHES[designs[0]][1].items():
        switched = text
        assert edits, name
        for old, new in edits:
            assert switched.count(old) == 1, name
            switched = switched.replace(old, new)
    assert "gsdf_ba_occupancy" in text and text.count("\n// gsdf_ba_empty:") == 1


def test_wrappers_refuse_what_they_do_not_take():
    _, (tp, ts) = _both(_random_arrays())
    with pytest.raises(ValueError, match="mode"):
        bt.ba_voxel_sums(tp, ts, GCFG, PCFG, "pose")
    with pytest.raises(ValueError, match="PhotoBAConfig"):
        bt.ba_voxel_sums(tp, ts, GCFG, None, "dist")
    meta = ts._replace(dist=torch.empty(ts.dist.shape, device="meta"))
    with pytest.raises(RuntimeError, match="no kernel"):
        bt.ba_voxel_sums(tp, meta, GCFG, PCFG, "energy")
    with pytest.raises(RuntimeError, match="no kernel"):
        bt.ba_pose_systems(tp, meta, GCFG, PCFG, ts.dist, tp.grad)


def test_args_structure_matches_the_kernel_source():
    """`BAArgs` mirrors the C structure field for field, and the source is
    built without fused multiply-adds (the plain version's rounding)."""
    with open(os.path.join(_build.CSRC, "ba_terms.cu")) as f:
        text = f.read()
    body = re.search(r"struct BAArgs \{(.*?)\};", text, re.S).group(1)
    fields = re.findall(r"^\s*(?:const void\*|int64_t|double)\s+([\w, ]+);",
                        body, re.M)
    names = [n.strip() for group in fields for n in group.split(",")]
    assert names == [n for n, _ in bt.BAArgs._fields_]
    assert all(ctypes.sizeof(t) == 8 for _, t in bt.BAArgs._fields_)
    assert _build.SOURCE_FLAGS["ba_terms.cu"] == ["-fmad=false"]


# ---------------------------------------------------------------------------
# on a card: the kernels against their plain versions
# ---------------------------------------------------------------------------


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def compare_on_card(problem, state, gcfg, pcfg):
    """Both kernels and their plain versions on the same CUDA tensors:
    raises AssertionError beyond the card's tolerances (module note),
    returns the largest deviations."""
    bt.reset_launch_count()
    e = bt.ba_voxel_sums(problem, state, gcfg, pcfg, "energy")
    e_ref = bt.ba_voxel_sums_reference(problem, state, gcfg, pcfg, "energy")
    d = bt.ba_voxel_sums(problem, state, gcfg, pcfg, "dist")
    d_ref = bt.ba_voxel_sums_reference(problem, state, gcfg, pcfg, "dist")
    n, mean = bt.ba_voxel_sums(problem, state, gcfg, pcfg, "mean")
    n_ref, mean_ref = bt.ba_voxel_sums_reference(problem, state, gcfg, pcfg,
                                                 "mean")
    H, b = bt.ba_pose_systems(problem, state, gcfg, pcfg, n_ref, mean_ref)
    H_ref, b_ref = bt.ba_pose_systems_reference(problem, state, gcfg, pcfg,
                                                n_ref, mean_ref)
    torch.cuda.synchronize()
    assert bt.launch_count == 3 and bt.pose_launch_count == 1
    # (one frame: both energies are 0, a float32 residue at most)
    e_rel = abs(float(e) - float(e_ref)) / max(abs(float(e_ref)), 1e-30)
    miss = (d - d_ref).abs() > CARD_DIST_ATOL + CARD_DIST_RTOL * d_ref.abs()
    h_rel = ((H - H_ref).abs().amax((1, 2))
             / H_ref.abs().amax((1, 2)).clamp(min=1e-30)).max()
    b_rel = ((b - b_ref).abs().amax(1)
             / b_ref.abs().amax(1).clamp(min=1e-30)).max()
    out = {"e_rel": e_rel, "dist_miss": float(miss.float().mean()),
           "n_equal": bool(torch.equal(n, n_ref)),
           "mean_err": float((mean - mean_ref).abs().max()),
           "H_rel": float(h_rel), "b_rel": float(b_rel)}
    assert e_rel <= CARD_E_RTOL, out
    assert out["dist_miss"] <= CARD_OUTLIERS, out
    assert out["n_equal"] and out["mean_err"] <= 1e-6, out
    assert out["H_rel"] <= SYS_RTOL and out["b_rel"] <= SYS_RTOL, out
    assert torch.equal(H, H.transpose(1, 2))
    # the same bits on a second run: fixed-order reductions, no atomics
    assert torch.equal(bt.ba_voxel_sums(problem, state, gcfg, pcfg, "energy"), e)
    H2, b2 = bt.ba_pose_systems(problem, state, gcfg, pcfg, n_ref, mean_ref)
    assert torch.equal(H2, H) and torch.equal(b2, b)
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("mix", MIX)
@pytest.mark.parametrize("loss", LOSSES)
@pytest.mark.parametrize("fixture", sorted(FIXTURES))
def test_cuda_kernels_match_plain(fixture, loss, mix):
    _need_card()
    problem, state = _shifted(fixture)
    tp = interop.problem_from_numpy(problem, "cuda")
    ts = interop.state_from_numpy(state, "cuda")
    compare_on_card(tp, ts, GCFG, _pcfg(loss, channel_mix_parity=mix))


@pytest.mark.gpu
def test_cuda_kernels_match_plain_at_vga():
    """The BA bench's problem (640x480 images, random voxels), cut to 8
    frames and 8192 voxels."""
    _need_card()
    from gradient_sdf_tpu_torch.tools import ba_bench

    arrays = ba_bench.bench_arrays(F=8, V=8192)
    gcfg, pcfg = ba_bench.bench_configs()
    tp = interop.problem_from_numpy(arrays[0], "cuda")
    ts = interop.state_from_numpy(arrays[1], "cuda")
    for loss in LOSSES:
        compare_on_card(tp, ts, gcfg, dataclasses.replace(pcfg, loss=loss))


def _path_arrays(F, path):
    """`_tiling_arrays` at F frames and the path's voxels, on the card,
    after checking that a launch over them takes that path."""
    V = PATH_VOXELS[path]
    assert _build.load().gsdf_ba_dense(V, F) == (path == "dense"), (path, F)
    problem, state = _tiling_arrays(F, V=V)
    return (interop.problem_from_numpy(problem, "cuda"),
            interop.state_from_numpy(state, "cuda"))


@pytest.mark.gpu
@pytest.mark.parametrize("mix", MIX)
@pytest.mark.parametrize("loss", LOSSES)
@pytest.mark.parametrize("F,path", CARD_SHAPES)
def test_cuda_kernels_match_plain_at_tiling_shapes(F, path, loss, mix):
    """Both paths at one frame and at their longest chunk (8 frames
    dense), the full-card paths over two and three chunks of frames (tails
    of 1 and 6 frames)."""
    _need_card()
    tp, ts = _path_arrays(F, path)
    compare_on_card(tp, ts, GCFG, _pcfg(loss, channel_mix_parity=mix))


@pytest.mark.gpu
def test_cuda_kernels_take_the_most_frames():
    """960 frames (the poses' shared memory at its largest; the pose
    kernel's over 48 KB)."""
    _need_card()
    tp, ts = _path_arrays(960, "full card")
    for loss in LOSSES:
        compare_on_card(tp, ts, GCFG, _pcfg(loss))


@pytest.mark.gpu
def test_cuda_alternation_runs_the_kernels_without_frame_temporaries():
    """An alternation on the card launches `ba_voxel_sums` four times and
    `ba_pose_systems` once, and allocates less than one [F, V, 3, 3]
    image Jacobian on top of its inputs."""
    _need_card()
    from gradient_sdf_tpu_torch.tools import ba_bench

    arrays = ba_bench.bench_arrays(F=8, V=8192)
    gcfg, pcfg = ba_bench.bench_configs()
    tp = interop.problem_from_numpy(arrays[0], "cuda")
    ts = interop.state_from_numpy(arrays[1], "cuda")
    ba_bench.alternation(tp, ts, gcfg, pcfg)
    torch.cuda.synchronize()
    bt.reset_launch_count()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ba_bench.alternation(tp, ts, gcfg, pcfg)
    torch.cuda.synchronize()
    V, F = arrays[0]["vis"].shape
    assert bt.launch_count == 4 and bt.pose_launch_count == 1
    assert torch.cuda.max_memory_allocated() - base < F * V * 36


@pytest.mark.gpu
def test_cuda_wrappers_raise_on_what_the_kernels_do_not_take():
    _need_card()
    problem, state = _random_arrays()
    tp = interop.problem_from_numpy(problem, "cuda")
    ts = interop.state_from_numpy(state, "cuda")
    with pytest.raises(ValueError, match="float32"):
        bt.ba_voxel_sums(tp._replace(grad=tp.grad.double()), ts, GCFG, PCFG,
                         "energy")
    with pytest.raises(ValueError, match="cuda"):
        bt.ba_voxel_sums(tp._replace(K=tp.K.cpu()), ts, GCFG, PCFG, "energy")
    big = 961
    many = tp._replace(images=tp.images[:1].expand(big, -1, -1, -1),
                       vis=tp.vis[:, :1].expand(-1, big))
    fs = ts._replace(R=ts.R[:1].expand(big, -1, -1), t=ts.t[:1].expand(big, -1))
    with pytest.raises(ValueError, match="at most"):
        bt.ba_voxel_sums(many, fs, GCFG, PCFG, "energy")
