"""Comparisons of PhotoBA's outputs with the plain reference
(`reference/photo_ba.py`): the problem the program built, each step of an
alternation from the program's own state before it, and a whole solve's
first and last energy."""

from __future__ import annotations

import math

import torch

from .reference import photo_ba as RP
from .reference import se3 as RS

STEP_KEYS = ("pose_t_gap_m", "pose_r_gap_rad", "energy_pose_gap_rel",
             "ba_dist_gap_m", "energy_dist_gap_rel")


def finite(x: float) -> float:
    """A reading; one that is not a number reads as infinitely far."""
    return x if math.isfinite(x) else math.inf


def rel_gap(value: float, ref: float) -> float:
    return finite(abs(value - ref) / max(abs(ref), 1e-30))


def pose_gaps(R_ref, t_ref, R, t) -> dict:
    """The largest translation gap (m) and rotation angle (rad) over the
    frames."""
    R_ref, t_ref = torch.as_tensor(R_ref), torch.as_tensor(t_ref)
    R = torch.as_tensor(R).to(R_ref.device)
    t = torch.as_tensor(t).to(t_ref.device)
    dt = torch.linalg.norm(t_ref.double() - t.double(), dim=-1)
    return {"pose_t_gap_m": finite(float(dt.max())),
            "pose_r_gap_rad": finite(float(RS.rotation_angle(R_ref, R).max()))}


def problem_mismatch(ref: RP.Problem, ref_dist, prog, prog_dist,
                     images, K) -> int:
    """Rows of the program's problem (`photo_ba.BAProblem`, padded, and its
    start dist) that differ from the reference's build in any field, plus
    the rows one has and the other lacks; the images and K against the
    benchmark's own, a differing one counting as a row each."""
    V = ref.vox.shape[0]
    Vp = prog.vox.shape[0]
    n_real = int(prog.vmask.sum())
    bad = abs(n_real - V) + int(prog.vmask[:V].logical_not().sum())
    v = min(V, Vp)

    def rows(a, b):
        a, b = a[:v].reshape(v, -1), b[:v].to(a.device).reshape(v, -1)
        return ~(a == b).all(dim=1)

    differ = (rows(ref.vox, prog.vox) | rows(ref.grad, prog.grad)
              | rows(ref.weight, prog.weight) | rows(ref.vis, prog.vis)
              | rows(ref_dist, prog_dist))
    bad += int(differ.sum())
    imgs = torch.as_tensor(images, device=prog.images.device)
    if imgs.shape != prog.images.shape:
        bad += imgs.shape[0]
    else:
        differ = (imgs != prog.images).reshape(imgs.shape[0], -1).any(dim=1)
        bad += int(differ.sum())
    bad += int(not torch.equal(torch.as_tensor(K, device=prog.K.device), prog.K))
    return bad


def vis_mismatch(ref_state: dict, ref_vis, prog_state: dict, prog_vis,
                 words: int) -> int:
    """Voxels of the blocks both grids hold whose first `words` visibility
    words differ (blocks matched by their coordinates)."""
    from .reference import grid as RG

    dev = prog_vis.device
    na = ref_state["num_active"]
    rc = ref_state["block_coords"][:na].to(dev).long()
    key = RG.pack_key(rc[:, 0], rc[:, 1], rc[:, 2], prog_state["dir_dim"])
    ps = prog_state["directory"].to(dev)[key.clamp(min=0)].long()
    found = (key >= 0) & (ps >= 0) & (ps < prog_state["num_active"])
    r = torch.nonzero(found).reshape(-1)
    a = ref_vis[:na].to(dev)[r][..., :words]
    b = prog_vis[ps[found]][..., :words]
    return int((a != b).any(dim=-1).sum())


def step_readings(problem: RP.Problem, s: RP.Settings, before: RP.State,
                  out: dict) -> dict:
    """One alternation judged from the state before it: the pose step
    against the reference's from `before`; the energy after it, the dist
    step and the energy after that against the reference's from the
    judged side's own state at each point. `out`: R, t after the pose
    step, e_pose, dist after the dist step, e_dist."""
    V = problem.vox.shape[0]
    mid_ref = RP.pose_step(problem, before, s)
    rd = pose_gaps(mid_ref.R, mid_ref.t, out["R"], out["t"])
    R = torch.as_tensor(out["R"], device=before.R.device).to(before.R.dtype)
    t = torch.as_tensor(out["t"], device=before.t.device).to(before.t.dtype)
    mid = RP.State(before.dist, R, t)
    rd["energy_pose_gap_rel"] = rel_gap(out["e_pose"],
                                        float(RP.energy(problem, mid, s)))
    d_ref = RP.dist_step(problem, mid, s)
    d_out = torch.as_tensor(out["dist"], device=d_ref.device)[:V].to(d_ref.dtype)
    rd["ba_dist_gap_m"] = finite(float((d_ref - d_out).abs().max()))
    end = RP.State(d_out, R, t)
    rd["energy_dist_gap_rel"] = rel_gap(out["e_dist"],
                                        float(RP.energy(problem, end, s)))
    return rd


def run_readings(energies: list, ref_energies: list) -> dict:
    """A whole solve's first and last energy against the reference's own
    solve from the same start."""
    return {"energy_first_gap_rel": rel_gap(energies[0], ref_energies[0]),
            "energy_last_gap_rel": rel_gap(energies[-1], ref_energies[-1])}
