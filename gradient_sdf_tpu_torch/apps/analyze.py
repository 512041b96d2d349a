"""Gradient-accuracy analysis CLI (the reference's MATLAB study, §3.5).

Port of `gradient_sdf_tpu/apps/analyze.py`, plus `--device` (default
`cuda`; a missing card is an error, not a move to the CPU). Consumes
`--save-sdf` dumps from Scan3D plus the sphere or box parameters written by
make_synth, and prints per-bin angle-error statistics for the stored
gradients vs central/forward/backward finite differences (paper Fig. 3);
`--json` writes the same numbers.

Usage:
  python -m gradient_sdf_tpu_torch.apps.analyze \
      --sdf-prefix out/gradient_sdf --spheres data/synth/spheres.txt
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from ..analysis import gradient_analysis as ga


def build_parser():
    p = argparse.ArgumentParser("analyze")
    p.add_argument("--sdf-prefix", required=True,
                   help="prefix passed to scan3d --save-sdf")
    p.add_argument("--spheres", default=None,
                   help="spheres.txt written by make_synth (cx cy cz r rows)")
    p.add_argument("--boxes", default=None,
                   help="boxes.txt written by make_synth --world box "
                        "(cx cy cz hx hy hz rows) — scores against exact "
                        "box normals instead")
    p.add_argument("--bins", type=int, default=10)
    p.add_argument("--json", default=None, help="write results as JSON")
    p.add_argument("--device", default="cuda",
                   help="torch device for the analysis (default cuda; the "
                        "run fails rather than fall back if it is missing)")
    return p


def main(argv=None):
    p = build_parser()
    a = p.parse_args(argv)
    if bool(a.spheres) == bool(a.boxes):
        p.error("pass exactly one of --spheres / --boxes")

    dump = ga.load_sdf_dump(a.sdf_prefix, a.device)
    if a.boxes:
        boxes = np.atleast_2d(np.loadtxt(a.boxes))
        res = ga.analyze_boxes(dump, boxes[:, :3], boxes[:, 3:],
                               num_bins=a.bins)
    else:
        spheres = np.atleast_2d(np.loadtxt(a.spheres))
        res = ga.analyze(dump, spheres[:, :3], spheres[:, 3],
                         num_bins=a.bins)

    for method, bins in res.items():
        print(f"== {method}")
        for b in bins:
            if b["count"] == 0:
                continue
            lo, hi = b["bin"]
            print(
                f"  |D| in [{lo:.3f},{hi:.3f}): n={b['count']:7d} "
                f"mean={b['mean']:6.2f} deg median={b['median']:6.2f} "
                f"rmse={b['rmse']:6.2f} p95={b['p95']:6.2f}"
            )
    if a.json:
        with open(a.json, "w") as f:
            json.dump(res, f, indent=2)
    return res


if __name__ == "__main__":
    main()
