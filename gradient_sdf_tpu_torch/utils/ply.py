"""PLY export (ASCII + binary).

The reference writes ASCII PLY for clouds and meshes
(`MapGradPixelSdf.cpp:189-218`, `LayeredMarchingCubesNoColor.cpp:721-757`,
`HrLayeredMarchingCubes.cpp:824-864`). We default to binary_little_endian
(~5x smaller/faster) with an `ascii=True` switch for byte-level parity runs.
Port: the same numpy writer as `gradient_sdf_tpu/utils/ply.py` without its
optional native fast path.
"""

from __future__ import annotations

import numpy as np


def save_point_cloud_ply(filename, points, normals=None, colors=None, ascii=False):
    points = np.asarray(points, np.float32)
    n = len(points)
    props = ["property float x", "property float y", "property float z"]
    cols = [points]
    if normals is not None:
        props += ["property float nx", "property float ny", "property float nz"]
        cols.append(np.asarray(normals, np.float32))
    if colors is not None:
        props += ["property uchar red", "property uchar green", "property uchar blue"]
    header = (
        ["ply", f"format {'ascii' if ascii else 'binary_little_endian'} 1.0",
         f"element vertex {n}"] + props + ["end_header"]
    )
    try:
        with open(filename, "wb") as f:
            f.write(("\n".join(header) + "\n").encode())
            fdata = np.concatenate(cols, axis=1) if len(cols) > 1 else points
            if ascii:
                for i in range(n):
                    row = " ".join(f"{v:g}" for v in fdata[i])
                    if colors is not None:
                        c = np.asarray(colors[i], np.uint8)
                        row += f" {c[0]} {c[1]} {c[2]}"
                    f.write((row + "\n").encode())
            else:
                if colors is not None:
                    rec = np.zeros(
                        n,
                        dtype=[("f", np.float32, fdata.shape[1]), ("c", np.uint8, 3)],
                    )
                    rec["f"] = fdata
                    rec["c"] = np.asarray(colors, np.uint8)
                    rec.tofile(f)
                else:
                    fdata.astype("<f4").tofile(f)
        return True
    except OSError:
        return False


def save_mesh_ply(filename, vertices, faces, vertex_colors=None, ascii=False):
    vertices = np.asarray(vertices, np.float32)
    faces = np.asarray(faces, np.int32)
    nv, nf = len(vertices), len(faces)
    props = ["property float x", "property float y", "property float z"]
    if vertex_colors is not None:
        props += ["property uchar red", "property uchar green", "property uchar blue"]
    header = (
        ["ply", f"format {'ascii' if ascii else 'binary_little_endian'} 1.0",
         f"element vertex {nv}"] + props +
        [f"element face {nf}", "property list uchar int vertex_indices", "end_header"]
    )
    try:
        with open(filename, "wb") as f:
            f.write(("\n".join(header) + "\n").encode())
            if ascii:
                for i in range(nv):
                    row = " ".join(f"{v:g}" for v in vertices[i])
                    if vertex_colors is not None:
                        c = np.asarray(vertex_colors[i], np.uint8)
                        row += f" {c[0]} {c[1]} {c[2]}"
                    f.write((row + "\n").encode())
                for tri in faces:
                    f.write(f"3 {tri[0]} {tri[1]} {tri[2]}\n".encode())
            else:
                if vertex_colors is not None:
                    rec = np.zeros(
                        nv, dtype=[("v", np.float32, 3), ("c", np.uint8, 3)]
                    )
                    rec["v"] = vertices
                    rec["c"] = np.asarray(vertex_colors, np.uint8)
                    rec.tofile(f)
                else:
                    vertices.astype("<f4").tofile(f)
                frec = np.zeros(nf, dtype=[("n", np.uint8), ("i", "<i4", 3)])
                frec["n"] = 3
                frec["i"] = faces
                frec.tofile(f)
        return True
    except OSError:
        return False


def load_ply(filename):
    """Minimal PLY reader (ascii + binary LE) for tests/round-trips."""
    with open(filename, "rb") as f:
        data = f.read()
    head_end = data.index(b"end_header\n") + len(b"end_header\n")
    header = data[:head_end].decode().splitlines()
    body = data[head_end:]
    fmt = next(l.split()[1] for l in header if l.startswith("format"))
    elems = []  # (name, count, [(type, name)])
    for line in header:
        parts = line.split()
        if parts[0] == "element":
            elems.append((parts[1], int(parts[2]), []))
        elif parts[0] == "property":
            if parts[1] == "list":
                elems[-1][2].append(("list", parts[2], parts[3], parts[4]))
            else:
                elems[-1][2].append((parts[1], parts[2]))
    out = {}
    tmap = {"float": "<f4", "float32": "<f4", "uchar": "u1", "uint8": "u1",
            "int": "<i4", "int32": "<i4", "double": "<f8"}
    if fmt == "ascii":
        lines = body.decode().splitlines()
        li = 0
        for name, count, props in elems:
            rows = []
            for _ in range(count):
                rows.append([float(x) for x in lines[li].split()])
                li += 1
            out[name] = np.array(rows)
        return out
    off = 0
    for name, count, props in elems:
        if any(p[0] == "list" for p in props):
            # assume single list property (faces)
            rows = []
            for _ in range(count):
                n = body[off]
                off += 1
                rows.append(np.frombuffer(body, "<i4", n, off).copy())
                off += 4 * n
            out[name] = np.array(rows)
        else:
            dt = np.dtype([(p[1], tmap[p[0]]) for p in props])
            arr = np.frombuffer(body, dt, count, off)
            off += dt.itemsize * count
            out[name] = arr
    return out
