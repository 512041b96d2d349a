"""Marching cubes over the block-sparse grid.

Port of `gradient_sdf_tpu/ops/marching_cubes.py` (the reference's layered
MC, `cpp/include/mesh/LayeredMarchingCubesNoColor.cpp:357-561`, redesigned
block-parallel): each occupied 8^3 block gathers a (8+1)^3 padded corner
field from itself and its 7 upper neighbors, classifies all 512 cubes at
once against the 256-case tables, and interpolates edge vertices, in chunks
of blocks. A cube emits geometry only if all 8 corners have weight > 0
(`computeLutIndex`, :611-636); zero-crossing interpolation is clamped
(:642-662). The tables are generated by the same numpy code as the JAX
module (`build_tables`, copied). Vertices are deduplicated on the host by
`native/dedup.c` (built at first use with the host C compiler, as the JAX
module's native library is), which numbers them in order of first
occurrence: the JAX module's vertex ids, faces and colours.

Corner convention: corner i sits at offset ((i)&1, (i>>1)&1, (i>>2)&1);
"inside" = dist < iso. Triangles are wound counter-clockwise seen from the
outside (positive side).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..config import GridConfig
from ..native import _build
from . import voxel_grid as vg

MAX_TRIS = 6  # per cube; generator asserts the true max fits

# ---------------------------------------------------------------------------
# table generation
# ---------------------------------------------------------------------------

CORNER_OFFSETS = np.array([[(i >> a) & 1 for a in range(3)] for i in range(8)])


def _make_edges():
    edges = []
    for axis in range(3):
        for i in range(8):
            o = CORNER_OFFSETS[i]
            if o[axis] == 0:
                j_off = o.copy()
                j_off[axis] = 1
                j = int(j_off[0] + 2 * j_off[1] + 4 * j_off[2])
                edges.append((i, j))
    # deterministic order: axis-major, then corner index
    return edges


EDGES = _make_edges()  # 12 (a, b) corner pairs
EDGE_INDEX = {frozenset(e): k for k, e in enumerate(EDGES)}


def _faces():
    """6 faces as (axis, side, [4 corner ids in cyclic order])."""
    faces = []
    for axis in range(3):
        u, v = [a for a in range(3) if a != axis]
        for side in (0, 1):
            cyc = []
            for du, dv in [(0, 0), (1, 0), (1, 1), (0, 1)]:
                o = [0, 0, 0]
                o[axis] = side
                o[u] = du
                o[v] = dv
                cyc.append(int(o[0] + 2 * o[1] + 4 * o[2]))
            faces.append((axis, side, cyc))
    return faces


FACES = _faces()


@functools.lru_cache(maxsize=1)
def build_tables():
    """Generate (edge_table [256] uint16, tri_table [256, MAX_TRIS*3] int8).

    For each of the 256 inside/outside configurations, cut edges are linked
    into closed cycles by walking faces: on each face the crossing segments
    pair cut edges; ambiguous faces (two diagonal inside corners) always
    *separate* the inside corners. Cycles are oriented by Newell normal
    against the local inside->outside direction and fan-triangulated.
    """
    tri_table = np.full((256, MAX_TRIS * 3), -1, dtype=np.int8)
    edge_table = np.zeros(256, dtype=np.int32)

    corner_pos = CORNER_OFFSETS.astype(np.float64)
    edge_mid = np.array([(corner_pos[a] + corner_pos[b]) * 0.5 for a, b in EDGES])

    # face adjacency: edge -> two faces containing it
    edge_faces = {k: [] for k in range(12)}
    face_edges_cyclic = []
    for fi, (axis, side, cyc) in enumerate(FACES):
        fe = []
        for idx in range(4):
            a, b = cyc[idx], cyc[(idx + 1) % 4]
            e = EDGE_INDEX[frozenset((a, b))]
            fe.append(e)
            edge_faces[e].append(fi)
        face_edges_cyclic.append(fe)

    for config in range(256):
        inside = [(config >> i) & 1 for i in range(8)]
        cut = [k for k, (a, b) in enumerate(EDGES) if inside[a] != inside[b]]
        if not cut:
            continue
        edge_table[config] = sum(1 << k for k in cut)

        # pair cut edges on each face
        partner = {}  # (edge, face) -> edge
        for fi, (axis, side, cyc) in enumerate(FACES):
            fcut = [e for e in face_edges_cyclic[fi] if e in cut]
            if not fcut:
                continue
            if len(fcut) == 2:
                e0, e1 = fcut
                partner[(e0, fi)] = e1
                partner[(e1, fi)] = e0
            else:  # 4 cut edges: diagonal pattern; separate inside corners
                assert len(fcut) == 4
                ins = [c for c in cyc if inside[c]]
                assert len(ins) == 2
                for c in ins:
                    inc = [
                        e
                        for e in fcut
                        if c in EDGES[e]
                    ]
                    assert len(inc) == 2
                    partner[(inc[0], fi)] = inc[1]
                    partner[(inc[1], fi)] = inc[0]

        # walk cycles
        visited = set()
        cycles = []
        for start in cut:
            if start in visited:
                continue
            cycle = [start]
            visited.add(start)
            face = edge_faces[start][0]
            cur = start
            while True:
                nxt = partner[(cur, face)]
                if nxt == cycle[0]:
                    break
                cycle.append(nxt)
                visited.add(nxt)
                f1, f2 = edge_faces[nxt]
                face = f2 if f1 == face else f1
                cur = nxt
            cycles.append(cycle)

        # orient + fan-triangulate
        tris = []
        for cycle in cycles:
            pts = edge_mid[cycle]
            # Newell normal
            nrm = np.zeros(3)
            for i in range(len(cycle)):
                p, q = pts[i], pts[(i + 1) % len(cycle)]
                nrm += np.cross(p, q)
            # inside -> outside direction from the cycle's own cut edges
            direc = np.zeros(3)
            for e in cycle:
                a, b = EDGES[e]
                if inside[a]:
                    direc += corner_pos[b] - corner_pos[a]
                else:
                    direc += corner_pos[a] - corner_pos[b]
            if np.dot(nrm, direc) < 0:
                cycle = cycle[::-1]
            for i in range(1, len(cycle) - 1):
                tris.append((cycle[0], cycle[i], cycle[i + 1]))

        assert len(tris) <= MAX_TRIS, (config, len(tris))
        flat = [v for t in tris for v in t]
        tri_table[config, : len(flat)] = flat

    return edge_table, tri_table


# ---------------------------------------------------------------------------
# device-side extraction
# ---------------------------------------------------------------------------

_NEIGHBOR_OFFSETS = np.array(
    [[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1],
     [1, 1, 0], [1, 0, 1], [0, 1, 1], [1, 1, 1]],
    dtype=np.int32,
)


def _gather_padded(grid: vg.VoxelGrid, block_slots: torch.Tensor,
                   gcfg: GridConfig, color_field=None):
    """For each block slot, assemble padded (B+1)^3 dist & weight (and
    optionally colour) fields (index order [z, y, x]) from the block and its
    +x/+y/+z neighbors. Missing neighbors contribute weight 0 (their cubes
    are gated off)."""
    B = gcfg.block_shape
    dev = grid.device
    coords = grid.block_coords[block_slots.long()]  # [M, 3]
    offsets = torch.as_tensor(_NEIGHBOR_OFFSETS, device=dev)
    neigh_keys = vg.pack_key(coords[:, None, :] + offsets, gcfg)  # [M, 8]
    neigh_slots = vg.lookup_keys(grid, neigh_keys, gcfg)
    present = neigh_slots >= 0
    safe = torch.where(present, neigh_slots, torch.zeros_like(neigh_slots)).long()

    zero = torch.zeros((), dtype=torch.float32, device=dev)
    d_blocks = torch.where(present[..., None], grid.dist[safe], zero)
    w_blocks = torch.where(present[..., None], grid.weight[safe], zero)
    d_blocks = d_blocks.reshape(-1, 8, B, B, B)
    w_blocks = w_blocks.reshape(-1, 8, B, B, B)

    M = d_blocks.shape[0]
    P = B + 1
    dpad = torch.zeros((M, P, P, P), dtype=torch.float32, device=dev)
    wpad = torch.zeros((M, P, P, P), dtype=torch.float32, device=dev)
    cpad = c_blocks = None
    if color_field is not None:
        C = color_field.shape[-1]
        c_blocks = torch.where(present[..., None, None], color_field[safe], zero)
        c_blocks = c_blocks.reshape(-1, 8, B, B, B, C)
        cpad = torch.zeros((M, P, P, P, C), dtype=torch.float32, device=dev)
    for oi in range(8):
        ox, oy, oz = (int(v) for v in _NEIGHBOR_OFFSETS[oi])
        # source region within the neighbor block, destination in the pad
        sz, sy, sx = (slice(0, 1) if o else slice(0, B) for o in (oz, oy, ox))
        dz, dy, dx = (slice(B, P) if o else slice(0, B) for o in (oz, oy, ox))
        dpad[:, dz, dy, dx] = d_blocks[:, oi, sz, sy, sx]
        wpad[:, dz, dy, dx] = w_blocks[:, oi, sz, sy, sx]
        if cpad is not None:
            cpad[:, dz, dy, dx] = c_blocks[:, oi, sz, sy, sx]
    return dpad, wpad, cpad, coords


def _extract_chunk(grid, block_slots, gcfg: GridConfig, iso: float, tri_tab,
                   color_field=None, origin: float = 0.0):
    """Triangles for a chunk of blocks: (tri_verts [M, B^3, MAX_TRIS, 3, 3],
    tri_valid [M, B^3, MAX_TRIS][, tri_colors [M, B^3, MAX_TRIS, 3, C]]).
    `origin` shifts all voxel centers (the HR lattice sits at
    voxel_size/2 * idx + voxel_size/4, `HrLayeredMarchingCubes.cpp:817-821`).
    """
    B = gcfg.block_shape
    dev = grid.device
    dpad, wpad, cpad, coords = _gather_padded(grid, block_slots, gcfg,
                                              color_field)
    M = dpad.shape[0]

    co = CORNER_OFFSETS  # [8,3] (x,y,z)
    # corner fields per cube: [M, B, B, B, 8] (cube index order z,y,x)
    d_c = torch.stack(
        [dpad[:, co[i, 2]:co[i, 2] + B, co[i, 1]:co[i, 1] + B, co[i, 0]:co[i, 0] + B]
         for i in range(8)], dim=-1)
    w_c = torch.stack(
        [wpad[:, co[i, 2]:co[i, 2] + B, co[i, 1]:co[i, 1] + B, co[i, 0]:co[i, 0] + B]
         for i in range(8)], dim=-1)

    cube_ok = torch.all(w_c > 0.0, dim=-1)  # [M,B,B,B]
    bits = torch.as_tensor(1 << np.arange(8), dtype=torch.int64, device=dev)
    config = torch.sum((d_c < iso).long() * bits, dim=-1)
    config = torch.where(cube_ok, config, torch.zeros_like(config))

    # interpolated vertex on each of the 12 edges: [M,B,B,B,12,3]
    ea = torch.as_tensor([e[0] for e in EDGES], device=dev)
    eb = torch.as_tensor([e[1] for e in EDGES], device=dev)
    da = d_c[..., ea]
    db = d_c[..., eb]
    denom = db - da
    frac = torch.where(torch.abs(denom) > 1e-12, (iso - da) / denom,
                       torch.full_like(denom, 0.5))
    frac = torch.clamp(frac, 0.0, 1.0)  # clamped interpolation (ref :642-662)
    cof = torch.as_tensor(co, dtype=torch.float32, device=dev)
    pa = cof[ea]  # [12,3]
    pb = cof[eb]
    everts = pa + frac[..., None] * (pb - pa)  # cube-local

    # cube base voxel index -> world position
    r = torch.arange(B, device=dev)
    zz, yy, xx = torch.meshgrid(r, r, r, indexing="ij")
    base = coords[:, None, None, None, :] * B + torch.stack([xx, yy, zz], dim=-1)
    everts = ((everts + base[..., None, :].to(torch.float32)) * gcfg.voxel_size
              + origin)

    tri_e = tri_tab[config]  # [M,B,B,B,MAX_TRIS*3]
    tvalid = (tri_e[..., 0::3] >= 0) & cube_ok[..., None]
    tri_e_safe = torch.clamp(tri_e, min=0)
    tv = torch.gather(everts, -2, tri_e_safe[..., None].expand(
        tuple(tri_e_safe.shape) + (3,)))  # [M,B,B,B,MAX_TRIS*3,3]
    out = (tv.reshape(M, B * B * B, MAX_TRIS, 3, 3),
           tvalid.reshape(M, B * B * B, MAX_TRIS))
    if color_field is None:
        return out
    # per-vertex colour: the two corners' colours, same edge weight as above
    C = color_field.shape[-1]
    c_c = torch.stack(
        [cpad[:, co[i, 2]:co[i, 2] + B, co[i, 1]:co[i, 1] + B,
              co[i, 0]:co[i, 0] + B, :] for i in range(8)], dim=-2)
    ca = c_c[..., ea, :]
    cb = c_c[..., eb, :]
    ecolors = ca + frac[..., None] * (cb - ca)  # [M,B,B,B,12,C]
    tc = torch.gather(ecolors, -2, tri_e_safe[..., None].expand(
        tuple(tri_e_safe.shape) + (C,)))
    return out + (tc.reshape(M, B * B * B, MAX_TRIS, 3, C),)


def extract_mesh(grid: vg.VoxelGrid, gcfg: GridConfig, iso: float = 0.0,
                 chunk: int = 256, dedup: bool = True, color_field=None,
                 origin: float = 0.0):
    """Extract the iso-surface triangle mesh.

    The device computes per-chunk fixed-size triangle soup; the host
    compacts and optionally dedups vertices (the reference appends
    duplicates, :705-711). Returns (vertices [V,3] f32, faces [F,3] i32)
    as numpy arrays and, when `color_field` ([num_blocks, B^3, C], on the
    grid's device) is given, per-vertex colours [V, C]: a deduplicated
    vertex keeps the colour of its first occurrence.
    """
    _, tri_np = build_tables()
    tri_tab = torch.as_tensor(tri_np.astype(np.int64), device=grid.device)
    na = int(grid.num_active)
    with_color = color_field is not None
    verts_out, colors_out = [], []
    for start in range(0, na, chunk):
        slots = torch.arange(start, min(start + chunk, na), device=grid.device)
        tv, tvalid, *tc = _extract_chunk(grid, slots, gcfg, iso, tri_tab,
                                         color_field, origin)
        verts_out.append(tv[tvalid].reshape(-1, 3).cpu().numpy())
        if with_color:
            colors_out.append(
                tc[0][tvalid].reshape(-1, tc[0].shape[-1]).cpu().numpy())

    def result(verts, faces, colors):
        return (verts, faces, colors) if with_color else (verts, faces)

    if not verts_out:
        return result(np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32),
                      np.zeros((0, 3), np.float32))
    flat = np.concatenate(verts_out, axis=0)
    colors = np.concatenate(colors_out, axis=0) if with_color else None
    faces = np.arange(len(flat), dtype=np.int32).reshape(-1, 3)
    if not (dedup and len(flat)):
        return result(flat, faces, colors)
    return result(*weld(flat, colors, gcfg.voxel_size * 1e-4))


def weld(soup: np.ndarray, colors, quantum: float, dedup=None):
    """Triangle soup [3T, 3] (+ per-vertex colours or None) -> (vertices,
    faces, colours): vertices merged by `dedup` (default `dedup_vertices`;
    `dedup_vertices_reference` gives the same arrays) at `quantum`, each
    keeping the colour of its first occurrence, and the triangles that
    collapsed dropped."""
    verts, inv, first = (dedup or dedup_vertices)(soup, quantum)
    if colors is not None:
        colors = colors[first]
    faces = inv.reshape(-1, 3)
    # drop degenerate triangles (iso-surface passing exactly through a
    # lattice corner collapses some triangles to edges/points)
    keep = (
        (faces[:, 0] != faces[:, 1])
        & (faces[:, 1] != faces[:, 2])
        & (faces[:, 0] != faces[:, 2])
    )
    return verts, faces[keep], colors


# ---------------------------------------------------------------------------
# vertex dedup
# ---------------------------------------------------------------------------


def _dedup_native():
    fn = _build.load("dedup").gsdf_dedup_vertices
    if not fn.argtypes:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_double,
                       ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int64
    return fn


def dedup_vertices(verts: np.ndarray, quantum: float):
    """Merge vertices whose coordinates round to the same multiple of
    `quantum` (half away from zero, in float64). Returns (unique f32 [M, 3],
    index_map int32 [N], first int64 [M]): ids in order of first occurrence,
    `unique[id] = verts[first[id]]`, the first vertex with that key. In
    native code (`native/dedup.c`); `dedup_vertices_reference` is the same
    function in Python."""
    verts = np.ascontiguousarray(verts, np.float32).reshape(-1, 3)
    n = len(verts)
    if n >= 2**31:
        raise ValueError(f"{n} vertices: ids are int32")
    index_map = np.empty(n, np.int32)
    first = np.empty(n, np.int64)
    m = _dedup_native()(verts.ctypes.data, n, float(quantum),
                        index_map.ctypes.data, first.ctypes.data)
    if m < 0:
        raise MemoryError(f"dedup of {n} vertices: out of memory")
    first = first[:m].copy()
    return verts[first], index_map, first


def dedup_vertices_reference(verts: np.ndarray, quantum: float):
    """Plain version of `dedup_vertices`: a loop over a dict."""
    verts = np.ascontiguousarray(verts, np.float32).reshape(-1, 3)
    x = verts.astype(np.float64) * (1.0 / float(quantum))
    t = np.trunc(x)
    keys = (t + (x - t >= 0.5) - (x - t <= -0.5)).astype(np.int64)
    ids: dict = {}
    index_map = np.empty(len(verts), np.int32)
    first = []
    for i, k in enumerate(map(tuple, keys.tolist())):
        if k not in ids:
            ids[k] = len(first)
            first.append(i)
        index_map[i] = ids[k]
    first = np.asarray(first, np.int64)
    return verts[first], index_map, first
