"""PixelSdfMap: classical trilinear TSDF baseline (`--scan-type base-sdf`).

Port of `gradient_sdf_tpu/models/pixel_sdf.py` (reference `MapPixelSdf`,
`cpp/include/sdf_tracker/MapPixelSdf.{h,cpp}`): the gradient map's fusion
gating and dist/weight updates but no stored gradient (fusion runs with
`accumulate_gradients=False`: the integrate pass adds F = 2 fields and its
merge leaves the gradient fields alone); queries interpolate the 8
corners (`MapPixelSdf.cpp:43-111`). The update transform is the correct one
(the reference's OMP variant), not the double-applied pose of
`MapPixelSdf.cpp:160`. Growth, the persistent accumulator and scratch, and
the host exports are `GradSdfMap`'s; there is no point cloud export, and
`save_sdf` writes the dist and weight files only.
"""

from __future__ import annotations

from ..config import PipelineConfig
from ..ops import fusion, query
from .grad_sdf import GradSdfMap, write_sdf_dump


class PixelSdfMap(GradSdfMap):
    def __init__(self, cfg: PipelineConfig, device="cuda"):
        super().__init__(cfg, with_vis=False, device=device)

    def _fuse(self, depth, R, t, kf_slot):
        self.grid = fusion.fuse_frame(
            self.grid, depth, self.cache, R, t, self.cfg.grid, self.cfg.fusion,
            accumulate_gradients=False, acc=self.acc, scratch=self.scratch)

    # -- queries ------------------------------------------------------------
    def tsdf(self, points):
        """Trilinear SDF + gradient at world points (…,3)."""
        phi, grad, _ = query.tsdf_trilinear(
            self.grid, self._tensor(points), self.cfg.grid, self.cfg.fusion)
        return phi, grad

    def weights(self, points):
        return query.weights_trilinear(self.grid, self._tensor(points),
                                       self.cfg.grid)

    # -- export (host side) -------------------------------------------------
    def extract_pc(self, filename: str, min_weight: float = 5.0) -> bool:
        raise NotImplementedError(
            "the baseline map stores no gradient: no oriented point cloud")

    def save_sdf(self, filename: str) -> bool:
        """Sparse dist/weight text dump (a subset of the gradient map's):
        grid_info + `lin_idx value` lines in _sdf_d and _sdf_weight."""
        vox, dist, weight, _ = self.occupied()
        return write_sdf_dump(filename, self.cfg.grid.voxel_size, vox, weight,
                              [("_sdf_d.txt", dist), ("_sdf_weight.txt", weight)])
