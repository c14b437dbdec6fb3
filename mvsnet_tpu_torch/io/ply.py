"""Binary little-endian PLY point-cloud writer (a copy of
mvsnet_tpu/io/ply.py).

Output-compatible with the final3d_model.ply files the reference pipeline
obtained from the external CUDA fusibile tool (reference: depthfusion.py:194-214,
scripts/utils.py:31-39) — the port's fusion (mvsnet_tpu_torch/fusion.py) writes these
directly, removing the GPU-binary dependency.
"""

from __future__ import annotations

import numpy as np
from mvsnet_tpu_torch.io.filesystem import open_file


def write_ply(path, points, colors=None, normals=None) -> None:
    """Write (N, 3) float points, optional (N, 3) uint8 colors / float normals."""
    points = np.asarray(points, dtype=np.float32)
    n = points.shape[0]
    props = ["property float x", "property float y", "property float z"]
    arrays = [points]
    if normals is not None:
        normals = np.asarray(normals, dtype=np.float32)
        props += ["property float nx", "property float ny", "property float nz"]
        arrays.append(normals)
    if colors is not None:
        colors = np.asarray(colors, dtype=np.uint8)
        props += ["property uchar red", "property uchar green", "property uchar blue"]
        arrays.append(colors)

    header = "\n".join(
        ["ply", "format binary_little_endian 1.0", f"element vertex {n}"]
        + props + ["end_header", ""]
    )
    fields = []
    for arr in arrays:
        for c in range(arr.shape[1]):
            fields.append((f"f{len(fields)}", arr.dtype.str))
    rec = np.empty(n, dtype=fields)
    i = 0
    for arr in arrays:
        for c in range(arr.shape[1]):
            rec[f"f{i}"] = arr[:, c]
            i += 1
    with open_file(path, "wb") as f:
        f.write(header.encode("ascii"))
        f.write(rec.tobytes())


def read_ply(path):
    """Minimal reader for PLYs produced by write_ply (floats + uchar colors)."""
    with open_file(path, "rb") as f:
        fields = []
        n = 0
        while True:
            line = f.readline().decode("ascii").strip()
            if line.startswith("element vertex"):
                n = int(line.split()[-1])
            elif line.startswith("property"):
                _, typ, name = line.split()
                fields.append((name, {"float": "<f4", "uchar": "u1"}[typ]))
            elif line == "end_header":
                break
        rec = np.frombuffer(f.read(int(n) * np.dtype(fields).itemsize),
                    dtype=fields, count=n)
    out = {name: rec[name] for name, _ in fields}
    points = np.stack([out["x"], out["y"], out["z"]], axis=1)
    colors = None
    if "red" in out:
        colors = np.stack([out["red"], out["green"], out["blue"]], axis=1)
    return points, colors
