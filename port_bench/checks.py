"""Comparisons of the program's outputs with the reference's: map states
by block coordinates (slot numbers are the program's business), poses by
the gap of their translations and the angle between their rotations."""

from __future__ import annotations

import torch

from .reference import grid as RG
from .reference import se3 as RS


def program_state(m, to_host: bool = False) -> dict:
    """A copy of a `GradSdfMap`'s grid (its allocated blocks) as the
    reference's state dict; one host read of the block count."""
    g = m.grid
    na = int(g.num_active)
    gc = m.cfg.grid

    def cp(a):
        return a.detach().to("cpu", copy=True) if to_host else a.detach().clone()

    return {"directory": cp(g.directory), "block_coords": cp(g.block_coords[:na]),
            "num_active": na, "capacity": int(g.num_blocks),
            "dist": cp(g.dist[:na]), "weight": cp(g.weight[:na]),
            "gx": cp(g.grad_x[:na]), "gy": cp(g.grad_y[:na]),
            "gz": cp(g.grad_z[:na]), "dir_dim": gc.dir_dim,
            "block_shape": gc.block_shape, "voxel_size": gc.voxel_size}


def to_device(st: dict, dev) -> dict:
    return {k: (v.to(dev) if torch.is_tensor(v) else v) for k, v in st.items()}


def compare_maps(ref: dict, prog: dict) -> dict:
    """Numbers of the program's map against the reference's:
    `block_mismatch`, the blocks allocated in one and not the other;
    over the voxels of the blocks both hold that either has observed,
    `dist_gap_m` the largest |dist gap|, `weight_gap_rel` the largest
    |weight gap| / max(weight, 1) and `grad_gap_rel` the largest gap of a
    gradient component / max(weight, 1) (the gradient is a weighted sum of
    unit normals), the weight being the reference's."""
    dev = prog["directory"].device
    ref = to_device(ref, dev)
    na_r, na_p = ref["num_active"], prog["num_active"]
    rc = ref["block_coords"][:na_r].long()
    key = RG.pack_key(rc[:, 0], rc[:, 1], rc[:, 2], prog["dir_dim"])
    ps = prog["directory"][key.clamp(min=0)].long()
    ps = torch.where(key >= 0, ps, torch.full_like(ps, -1))
    found = (ps >= 0) & (ps < na_p)
    matched = int(found.sum())
    out = {"block_mismatch": (na_r - matched) + (na_p - matched)}
    r = torch.nonzero(found).reshape(-1)
    p = ps[found]
    w_r, w_p = ref["weight"][r].float(), prog["weight"][p].float()
    seen = (w_r > 0) | (w_p > 0)
    scale = torch.clamp(w_r, min=1.0)

    def gap(a, b, denom=None):
        d = (a.float() - b.float()).abs()
        if denom is not None:
            d = d / denom
        d = torch.where(seen, d, torch.zeros_like(d))
        return float(d.max()) if d.numel() else 0.0

    out["dist_gap_m"] = gap(ref["dist"][r], prog["dist"][p])
    out["weight_gap_rel"] = gap(w_r, w_p, scale)
    out["grad_gap_rel"] = max(gap(ref[k][r], prog[k][p], scale)
                              for k in ("gx", "gy", "gz"))
    return out


def pose_gaps(R_ref, t_ref, R_out, t_out) -> dict:
    R_ref, t_ref = torch.as_tensor(R_ref), torch.as_tensor(t_ref)
    R_out = torch.as_tensor(R_out).to(R_ref.device)
    t_out = torch.as_tensor(t_out).to(t_ref.device)
    return {"pose_t_gap_m": float(torch.linalg.norm(t_ref.double() - t_out.double())),
            "pose_r_gap_rad": float(RS.rotation_angle(R_ref, R_out))}


def worst(readings: list, keys) -> dict:
    """The largest of each number over a list of readings (0 if none)."""
    return {k: max([r[k] for r in readings if k in r] or [0.0]) for k in keys}
