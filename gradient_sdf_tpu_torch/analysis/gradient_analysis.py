"""Gradient-accuracy analysis on the synthetic worlds (paper Fig. 3).

Port of `gradient_sdf_tpu/analysis/gradient_analysis.py` (the reference's
`matlab/GradientAnalysisSpheres.m:42-224`, `matlab/phi_statistics.m:57-77`):
the stored per-voxel gradients and the central, forward and backward finite
differences of the fused distance field are scored against the analytic
normals of the sphere or box world, binned by distance to the surface.

The `save_sdf` text dump (`MapGradPixelSdf.cpp:222-296`) is parsed on the
host; the dense fields then go to `device` (the card by default) and the
work runs there in float64, as the JAX module's numpy does. Medians and
percentiles are taken from a sort with numpy's rules (the mean of the two
middle values; linear interpolation), not with `torch.median` (the lower
middle value) or `torch.quantile` (which refuses more than 2^24 values). The
box world's field takes the SIGNED argmin over the boxes, as
`data/synth.box_sdf` does; the JAX module's `box_true_field` takes the
argmin of |sdf|, which picks another box for a point inside one box that is
nearer another's surface.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..data import synth
from ..utils import device as device_mod

FIELDS = [("d", "_sdf_d.txt"), ("w", "_sdf_weight.txt"), ("n0", "_sdf_n0.txt"),
          ("n1", "_sdf_n1.txt"), ("n2", "_sdf_n2.txt")]


def load_sdf_dump(prefix: str, device="cuda"):
    """Read `<prefix>_grid_info.txt` + the sparse value files into dense
    float64 [X, Y, Z] tensors on `device`: d, w, n0, n1, n2 (missing voxels:
    d = 0, w = 0), with voxel_size, vmin and dim."""
    dev = device_mod.require(device)
    info = {}
    with open(prefix + "_grid_info.txt") as f:
        for line in f:
            key, _, vals = line.partition(":")
            info[key.strip()] = [float(v) for v in vals.split()]
    dim = np.array(info["voxel dim"], dtype=int)
    vmin = np.array(info["voxel min"], dtype=int)
    out = {"voxel_size": info["voxel size"][0], "dim": dim, "vmin": vmin}
    for name, suffix in FIELDS:
        arr = np.zeros(dim[0] * dim[1] * dim[2], np.float64)
        path = prefix + suffix
        if os.path.isfile(path):
            data = np.loadtxt(path, ndmin=2)
            if data.size:
                arr[data[:, 0].astype(int)] = data[:, 1]
        # lin = dim0*dim1*(z-zmin) + dim0*(y-ymin) + (x-xmin): x fastest
        out[name] = torch.from_numpy(
            arr.reshape(dim[2], dim[1], dim[0]).transpose(2, 1, 0).copy()).to(dev)
    return out


def _finite_diff(d: torch.Tensor, w: torch.Tensor, voxel_size: float):
    """Central/forward/backward gradients of the dense dist field; a
    component is valid only where the participating voxels are observed."""
    grads, valids = {}, {}
    for mode in ("central", "forward", "backward"):
        g = torch.zeros(tuple(d.shape) + (3,), dtype=d.dtype, device=d.device)
        v = torch.ones(d.shape, dtype=torch.bool, device=d.device)
        for ax in range(3):
            dp = torch.roll(d, -1, dims=ax)
            dm = torch.roll(d, 1, dims=ax)
            wp = torch.roll(w, -1, dims=ax) > 0
            wm = torch.roll(w, 1, dims=ax) > 0
            if mode == "central":
                g[..., ax] = (dp - dm) / (2 * voxel_size)
                v &= wp & wm
            elif mode == "forward":
                g[..., ax] = (dp - d) / voxel_size
                v &= wp
            else:
                g[..., ax] = (d - dm) / voxel_size
                v &= wm
            # roll wraps; kill the boundary slices
            v.select(ax, 0).fill_(False)
            v.select(ax, -1).fill_(False)
        grads[mode] = g
        valids[mode] = v & (w > 0)
    return grads, valids


def angle_error_deg(g: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    gn = g / torch.clamp(torch.linalg.norm(g, dim=-1, keepdim=True), min=1e-12)
    rn = ref / torch.clamp(torch.linalg.norm(ref, dim=-1, keepdim=True), min=1e-12)
    cos = torch.clamp(torch.sum(gn * rn, dim=-1), -1.0, 1.0)
    return torch.rad2deg(torch.arccos(cos))


def _lerp(a: float, b: float, t: float) -> float:
    """numpy's linear interpolation between neighbours (`_lerp`)."""
    diff = b - a
    return b - diff * (1.0 - t) if t >= 0.5 else a + diff * t


def percentile_sorted(s: torch.Tensor, q: float) -> float:
    """`np.percentile(x, q)` (linear method) of the values sorted in `s`."""
    n = s.numel()
    virtual = (q / 100.0) * (n - 1)
    lo = int(np.floor(virtual))
    hi = min(lo + 1, n - 1)
    return _lerp(float(s[lo]), float(s[hi]), virtual - lo)


def median_sorted(s: torch.Tensor) -> float:
    """`np.median`: the middle value, or the mean of the two middle ones."""
    n = s.numel()
    if n % 2:
        return float(s[n // 2])
    return float((s[n // 2 - 1] + s[n // 2]) / 2.0)


def bin_stats(errors: torch.Tensor, dist_to_surface: torch.Tensor, bin_edges):
    """Per-bin mean/median/rmse/95th percentile (phi_statistics.m:57-77)."""
    stats = []
    absd = torch.abs(dist_to_surface)
    for lo, hi in zip(bin_edges[:-1], bin_edges[1:]):
        e = errors[(absd >= float(lo)) & (absd < float(hi))]
        if e.numel() == 0:
            stats.append(dict(bin=(float(lo), float(hi)), count=0))
            continue
        s = torch.sort(e).values
        stats.append(dict(
            bin=(float(lo), float(hi)), count=int(e.numel()),
            mean=float(e.mean()), median=median_sorted(s),
            rmse=float(torch.sqrt((e ** 2).mean())),
            p95=percentile_sorted(s, 95),
        ))
    return stats


def grid_points(dump: dict) -> torch.Tensor:
    """World coordinates [X, Y, Z, 3] (float64) of the dump's voxel centres,
    on the dump's device."""
    vs = dump["voxel_size"]
    dim, vmin = dump["dim"], dump["vmin"]
    dev = dump["d"].device
    axes = [(torch.arange(int(dim[k]), dtype=torch.float64, device=dev)
             + int(vmin[k])) * vs for k in range(3)]
    return torch.stack(torch.meshgrid(*axes, indexing="ij"), dim=-1)


def box_true_field(pts: torch.Tensor, centers, half_extents):
    """Analytic union-box SDF + INWARD unit normal at points (…, 3):
    `data/synth.box_sdf` (the signed argmin over the boxes) in the points'
    precision, its gradient negated to point inward as the stored
    gradients do."""
    world = synth.BoxWorld(
        centers=torch.tensor(np.asarray(centers), dtype=pts.dtype,
                             device=pts.device),
        half_extents=torch.tensor(np.asarray(half_extents), dtype=pts.dtype,
                                  device=pts.device))
    sdf, grad = synth.box_sdf(world, pts)
    return sdf, -grad


def analyze_boxes(dump: dict, centers, half_extents, num_bins: int = 10,
                  max_band_voxels: float = 10.0):
    """Stored vs FD gradients scored against the exact normals of the box
    world (`data/synth.BoxWorld`): the planar-face analogue of the paper's
    sphere analysis."""
    true_sdf, true_n = box_true_field(grid_points(dump), centers, half_extents)
    return _analyze_field(dump, true_sdf, true_n, num_bins, max_band_voxels)


def analyze(dump: dict, sphere_centers, sphere_radii, num_bins: int = 10,
            max_band_voxels: float = 10.0):
    """Stored vs FD gradient angle errors binned by |distance to surface|
    (in voxels). Returns dict of method -> bin stats."""
    pts = grid_points(dump)
    c = torch.as_tensor(np.asarray(sphere_centers), dtype=pts.dtype,
                        device=pts.device)
    r = torch.as_tensor(np.asarray(sphere_radii), dtype=pts.dtype,
                        device=pts.device)
    diff = pts[..., None, :] - c                    # [..., S, 3]
    dists = torch.linalg.norm(diff, dim=-1) - r
    s = torch.argmin(torch.abs(dists), dim=-1)
    true_sdf = torch.gather(dists, -1, s[..., None])[..., 0]
    nearest = torch.gather(
        diff, -2, s[..., None, None].expand(tuple(s.shape) + (1, 3)))[..., 0, :]
    # stored gradients are inward-pointing -> reference normal is -outward
    true_n = -nearest / torch.clamp(
        torch.linalg.norm(nearest, dim=-1, keepdim=True), min=1e-12)
    return _analyze_field(dump, true_sdf, true_n, num_bins, max_band_voxels)


def _analyze_field(dump: dict, true_sdf: torch.Tensor, true_n: torch.Tensor,
                   num_bins: int, max_band_voxels: float):
    vs = dump["voxel_size"]
    w = dump["w"]
    stored = torch.stack([dump["n0"], dump["n1"], dump["n2"]], dim=-1)
    fd, fd_valid = _finite_diff(dump["d"], w, vs)

    band = torch.abs(true_sdf) < max_band_voxels * vs
    edges = np.linspace(0.0, max_band_voxels * vs, num_bins + 1)

    results = {}
    mask = (w > 0) & band & (torch.linalg.norm(stored, dim=-1) > 1e-12)
    results["stored"] = bin_stats(
        angle_error_deg(stored[mask], true_n[mask]), true_sdf[mask], edges)
    for mode in ("central", "forward", "backward"):
        # the stored dist is negative in observed free space, so its finite
        # differences point inward like the stored gradients: no sign flip
        m = fd_valid[mode] & band
        results[mode] = bin_stats(
            angle_error_deg(fd[mode][m], true_n[m]), true_sdf[m], edges)
    return results
