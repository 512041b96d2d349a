"""Port colour upsampler (`gradient_sdf_tpu_torch/models/color_upsampler.py`)
against the JAX package, on the CPU.

One spheres scene (96x72, 4 views, keyframe slots 0, 31, 63 and 5 of a
two-word bitfield) is fused by the JAX package and carried across with
`utils/interop`; both packages then expand, colour and extract it.
Tolerances: the expansion is the same numpy arithmetic (equal arrays);
albedo 1e-5 (the same float32 lerp, summed in frame order in both);
the half-voxel grid holds the same values in the same slots (equal).
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from gradient_sdf_tpu.config import FusionConfig, GridConfig
from gradient_sdf_tpu.data import synth as jsynth
from gradient_sdf_tpu.models import color_upsampler as jcu
from gradient_sdf_tpu.ops import fusion as jfu
from gradient_sdf_tpu.ops import normals as jnorm
from gradient_sdf_tpu.ops import voxel_grid as jvg
from gradient_sdf_tpu.utils.ply import load_ply
from gradient_sdf_tpu_torch.models import color_upsampler as tcu
from gradient_sdf_tpu_torch.utils import interop

W, H = 96, 72
K = np.array([[78.75, 0, 47.5], [0, 78.75, 35.5], [0, 0, 1]], np.float32)
GCFG = GridConfig(voxel_size=0.02, num_blocks=1024, dir_dim=64)
SLOTS = [0, 31, 63, 5]


@pytest.fixture(scope="module")
def scene():
    fcfg = FusionConfig(trunc_voxels=5.0)
    world = jsynth.random_spheres(seed=2)
    cache = jnorm.build_cache(W, H, K, window=5)
    jg = jvg.create(GCFG)
    vis = jnp.zeros((GCFG.num_blocks, GCFG.voxels_per_block, 2), jnp.uint32)
    poses = jsynth.orbit_poses(n=4, radius=2.0, arc=np.deg2rad(20.0))
    for (R, t), slot in zip(poses, SLOTS):
        d = jsynth.render_depth(world, jnp.asarray(R), jnp.asarray(t), K, W, H)
        jg, vis = jfu.fuse_frame(jg, d, cache, jnp.asarray(R), jnp.asarray(t),
                                 GCFG, fcfg, vis=vis, kf_slot=slot)
    tg = interop.grid_from_numpy({k: np.asarray(v)
                                  for k, v in jg._asdict().items()})
    tvis = interop.vis_from_numpy(np.asarray(vis))
    # values above 1 so that the clamp after the mean has something to cut
    images = np.random.RandomState(21).uniform(0, 1.4, (4, H, W, 3))
    poses = [(np.asarray(R, np.float32), np.asarray(t, np.float32))
             for R, t in poses]
    jhr = jcu.build_hr_voxels(jg, vis, SLOTS, GCFG)
    jhr = jcu.compute_color(jhr, images.astype(np.float32), poses, K, GCFG)
    return dict(jg=jg, jvis=vis, tg=tg, tvis=tvis, poses=poses, jhr=jhr,
                images=images.astype(np.float32))


def _assert_hr_equal(got, want, albedo_atol=0.0):
    for name in jcu.HrVoxels._fields:
        g, w = np.asarray(getattr(got, name)), np.asarray(getattr(want, name))
        assert g.dtype == w.dtype and g.shape == w.shape, name
        if name == "albedo":
            np.testing.assert_allclose(g, w, atol=albedo_atol, err_msg=name)
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)


def test_build_hr_voxels_matches_jax(scene):
    want = jcu.build_hr_voxels(scene["jg"], scene["jvis"], SLOTS, GCFG)
    got = tcu.build_hr_voxels(scene["tg"], scene["tvis"], SLOTS, GCFG)
    assert len(got.vox) > 1000
    _assert_hr_equal(got, want)
    # every slot sees voxels: bit 31 and the second word are read as unsigned
    assert got.vis.any(axis=0).all() and not got.vis.all()


def test_compute_color_matches_jax(scene):
    hr = tcu.build_hr_voxels(scene["tg"], scene["tvis"], SLOTS, GCFG)
    got = tcu.compute_color(hr, torch.from_numpy(scene["images"]),
                            scene["poses"], K, GCFG)
    _assert_hr_equal(got, scene["jhr"], albedo_atol=1e-5)
    a = got.albedo
    assert a.min() >= 0.0 and a.max() == 1.0  # clamped after the mean
    assert (a.reshape(len(a), -1).max(axis=1) > 0).mean() > 0.5


def test_compute_color_needs_all_eight_subvoxels_in_the_image(scene):
    """Shift the principal point so that part of the surface leaves the
    image: a voxel with any subvoxel outside gets no colour from that frame,
    in both packages alike."""
    Ks = K.copy()
    Ks[0, 2] += 30.0
    hr = tcu.build_hr_voxels(scene["tg"], scene["tvis"], SLOTS, GCFG)
    got = tcu.compute_color(hr, torch.from_numpy(scene["images"]),
                            scene["poses"], Ks, GCFG)
    want = jcu.compute_color(scene["jhr"], scene["images"], scene["poses"], Ks,
                             GCFG)
    np.testing.assert_allclose(got.albedo, want.albedo, atol=1e-5)
    lit = got.albedo.reshape(len(hr.vox), -1).max(axis=1) > 0
    full = scene["jhr"].albedo.reshape(len(hr.vox), -1).max(axis=1) > 0
    assert lit.sum() < full.sum()
    # a voxel is coloured as a whole or not at all
    per_sub = got.albedo.max(axis=-1) > 0
    assert (per_sub.all(axis=1) | ~per_sub.any(axis=1)).mean() > 0.99


def test_interop_hr_roundtrip(scene):
    hr = interop.hr_from_numpy(scene["jhr"]._asdict())
    assert isinstance(hr, tcu.HrVoxels)
    _assert_hr_equal(hr, scene["jhr"])
    back = jcu.HrVoxels(**interop.hr_to_numpy(hr))
    _assert_hr_equal(back, scene["jhr"])


def test_build_hr_grid_matches_jax(scene):
    hr = interop.hr_from_numpy(scene["jhr"]._asdict())
    jgrid, jcolor, jcfg = jcu.build_hr_grid(scene["jhr"], GCFG)
    tgrid, tcolor, tcfg = tcu.build_hr_grid(hr, GCFG, "cpu")
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert tcfg.voxel_size == GCFG.voxel_size / 2 and tcfg.dir_dim == 128
    assert tcfg.num_blocks == 4096
    assert int(tgrid.num_active) == int(jgrid.num_active) > 100
    for name in ("directory", "block_coords", "dist", "weight"):
        np.testing.assert_array_equal(getattr(tgrid, name).numpy(),
                                      np.asarray(getattr(jgrid, name)),
                                      err_msg=name)
    np.testing.assert_array_equal(tcolor.numpy(), np.asarray(jcolor))
    # the cap: 4x the blocks, at most 2^17
    big = dataclasses.replace(GCFG, num_blocks=2 ** 16, dir_dim=8)
    empty = hr._replace(**{k: getattr(hr, k)[:0] for k in hr._fields})
    assert tcu.build_hr_grid(empty, big, "cpu")[2].num_blocks == 2 ** 17


def test_extract_mesh_hr_and_cloud_match_jax(scene, tmp_path):
    hr = interop.hr_from_numpy(scene["jhr"]._asdict())
    paths = {}
    for tag, mod, extra in (("j", jcu, ()), ("t", tcu, ("cpu",))):
        paths[tag] = (str(tmp_path / f"{tag}_mesh.ply"),
                      str(tmp_path / f"{tag}_cloud.ply"))
        src = scene["jhr"] if tag == "j" else hr
        assert mod.extract_mesh_hr(src, paths[tag][0], GCFG, *extra)
        assert mod.extract_cloud(src, paths[tag][1], GCFG)
    jm, tm = load_ply(paths["j"][0]), load_ply(paths["t"][0])
    assert len(tm["vertex"]) == len(jm["vertex"]) > 100
    assert len(tm["face"]) == len(jm["face"]) > 100
    assert "red" in tm["vertex"].dtype.names
    # the dedups number vertices differently: compare as sorted point sets
    def rows(m, names):
        a = np.stack([m["vertex"][n].astype(np.float64) for n in names], 1)
        return a[np.lexsort(a.T[::-1])]

    from scipy.spatial import cKDTree

    jx, tx = rows(jm, "xyz"), rows(tm, "xyz")
    assert cKDTree(jx).query(tx)[0].max() <= 1e-6
    for ch in ("red", "green", "blue"):
        assert abs(float(tm["vertex"][ch].mean()) - float(jm["vertex"][ch].mean())) < 0.5
    # the cloud is host numpy arithmetic in both packages: equal files
    jc, tc = load_ply(paths["j"][1]), load_ply(paths["t"][1])
    assert len(tc["vertex"]) == len(jc["vertex"]) > 50
    for n in jc["vertex"].dtype.names:
        np.testing.assert_array_equal(tc["vertex"][n], jc["vertex"][n], err_msg=n)
