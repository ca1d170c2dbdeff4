"""Self-contained PLY reader/writer (binary little-endian + ascii).

Port of gs2m_tpu/data/ply.py (numpy only). Files are byte-compatible with
the JAX package's, header comment included, so snapshots move freely
between the two packages:

* point clouds: x y z nx ny nz red green blue (u1)
* Gaussian snapshots: x y z nx ny nz f_dc_* f_rest_* opacity scale_* rot_*
  albedo_* roughness metallic, all f4 (f_dc/f_rest flattened channel-major,
  i.e. (N, K, 3) -> transpose -> (N, 3K))
* meshes: vertex x y z (+ optional uchar rgb) and face vertex_indices lists
  (uchar count, int indices)
"""
from __future__ import annotations

import numpy as np

_DTYPES = {
    "char": "i1", "int8": "i1",
    "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2",
    "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4",
    "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4",
    "double": "f8", "float64": "f8",
}
_NAMES = {"i1": "char", "u1": "uchar", "i2": "short", "u2": "ushort",
          "i4": "int", "u4": "uint", "f4": "float", "f8": "double"}


def read_ply(path: str) -> dict[str, np.ndarray]:
    """Read a PLY file -> {element_name: structured array}. List properties
    (e.g. face vertex_indices) come back as a (N, K) int array when uniform."""
    with open(path, "rb") as f:
        data = f.read()
    end = data.find(b"end_header\n")
    if end < 0:
        raise ValueError(f"{path}: no end_header")
    header = data[:end].decode("ascii").splitlines()
    body = data[end + len(b"end_header\n"):]
    if header[0].strip() != "ply":
        raise ValueError(f"{path}: not a PLY file")

    fmt = None
    elements = []  # (name, count, [(prop_name, dtype | ('list', cnt_dt, val_dt))])
    for line in header[1:]:
        parts = line.strip().split()
        if not parts or parts[0] == "comment":
            continue
        if parts[0] == "format":
            fmt = parts[1]
        elif parts[0] == "element":
            elements.append((parts[1], int(parts[2]), []))
        elif parts[0] == "property":
            if parts[1] == "list":
                elements[-1][2].append(
                    (parts[4], ("list", _DTYPES[parts[2]], _DTYPES[parts[3]])))
            else:
                elements[-1][2].append((parts[2], _DTYPES[parts[1]]))

    out = {}
    if fmt == "ascii":
        text = body.decode("ascii").split()
        pos = 0
        for name, count, props in elements:
            if any(isinstance(d, tuple) for _, d in props):
                rows = []
                for _ in range(count):
                    k = int(text[pos])
                    pos += 1
                    rows.append([int(x) for x in text[pos:pos + k]])
                    pos += k
                out[name] = np.asarray(rows)
            else:
                arr = np.empty(count, dtype=[(p, d) for p, d in props])
                n_props = len(props)
                flat = text[pos:pos + count * n_props]
                pos += count * n_props
                mat = np.asarray(flat, dtype=np.float64).reshape(count, n_props)
                for i, (p, d) in enumerate(props):
                    arr[p] = mat[:, i].astype(d)
                out[name] = arr
        return out

    endian = "<" if fmt == "binary_little_endian" else ">"
    off = 0
    for name, count, props in elements:
        if any(isinstance(d, tuple) for _, d in props):
            _, (_, cnt_dt, val_dt) = props[0]
            if count == 0:
                out[name] = np.zeros((0, 3), np.int32)
                continue
            cnt_size = np.dtype(cnt_dt).itemsize
            k = int(np.frombuffer(body, endian + cnt_dt, 1, off)[0])
            row_bytes = cnt_size + k * np.dtype(val_dt).itemsize
            raw = np.frombuffer(body, np.uint8, count * row_bytes,
                                off).reshape(count, row_bytes)
            vals = raw[:, cnt_size:].copy().view(endian + val_dt).reshape(count, k)
            out[name] = vals.astype(np.int64)
            off += count * row_bytes
        else:
            dt = np.dtype([(p, endian + d) for p, d in props])
            out[name] = np.frombuffer(body, dt, count, off).copy()
            off += count * dt.itemsize
    return out


def write_ply(path: str, elements: dict[str, np.ndarray]) -> None:
    """Write {element_name: structured array | (N, K) int array} as
    binary_little_endian PLY. A plain (N, K) int array is written as the
    list property 'vertex_indices' (faces)."""
    lines = ["ply", "format binary_little_endian 1.0",
             "comment generated by gs2m_tpu"]
    payloads = []
    for name, arr in elements.items():
        if arr.dtype.names is None:  # list property (faces)
            n, k = arr.shape
            lines.append(f"element {name} {n}")
            lines.append("property list uchar int vertex_indices")
            row = np.empty(n, dtype=[("c", "u1"), ("v", "<i4", (k,))])
            row["c"] = k
            row["v"] = arr.astype("<i4")
            payloads.append(row.tobytes())
            continue
        lines.append(f"element {name} {len(arr)}")
        fields = []
        for p in arr.dtype.names:
            base = arr.dtype[p].str.lstrip("<>|=")
            lines.append(f"property {_NAMES[base]} {p}")
            fields.append((p, "<" + base))
        payloads.append(np.ascontiguousarray(arr.astype(fields)).tobytes())
    lines.append("end_header")
    with open(path, "wb") as f:
        f.write(("\n".join(lines) + "\n").encode("ascii"))
        for p in payloads:
            f.write(p)


# --- point clouds ----------------------------------------------------------------

def store_point_cloud(path: str, xyz: np.ndarray, rgb: np.ndarray) -> None:
    """xyz (N,3) float, rgb (N,3) in 0..255."""
    n = xyz.shape[0]
    arr = np.empty(n, dtype=[("x", "f4"), ("y", "f4"), ("z", "f4"),
                             ("nx", "f4"), ("ny", "f4"), ("nz", "f4"),
                             ("red", "u1"), ("green", "u1"), ("blue", "u1")])
    arr["x"], arr["y"], arr["z"] = xyz.T.astype(np.float32)
    arr["nx"] = arr["ny"] = arr["nz"] = np.zeros(n, np.float32)
    arr["red"], arr["green"], arr["blue"] = (
        np.clip(rgb, 0, 255).astype(np.uint8).T)
    write_ply(path, {"vertex": arr})


def fetch_point_cloud(path: str):
    """-> (points (N,3) f32, colors (N,3) f32 in [0,1], normals (N,3) f32)."""
    v = read_ply(path)["vertex"]
    pts = np.stack([v["x"], v["y"], v["z"]], -1).astype(np.float32)
    names = v.dtype.names
    if all(c in names for c in ("red", "green", "blue")):
        cols = np.stack([v["red"], v["green"], v["blue"]],
                        -1).astype(np.float32) / 255.0
    else:
        cols = np.random.rand(*pts.shape).astype(np.float32) / 255.0
    if all(c in names for c in ("nx", "ny", "nz")):
        normals = np.stack([v["nx"], v["ny"], v["nz"]], -1).astype(np.float32)
    else:
        normals = np.zeros_like(pts)
    return pts, cols, normals


# --- meshes ------------------------------------------------------------------------

def store_mesh(path: str, vertices: np.ndarray, faces: np.ndarray,
               colors: np.ndarray | None = None) -> None:
    """vertices (N,3) f32, faces (M,3) int, colors optional (N,3) in [0,1]."""
    n = vertices.shape[0]
    if colors is not None:
        arr = np.empty(n, dtype=[("x", "f4"), ("y", "f4"), ("z", "f4"),
                                 ("red", "u1"), ("green", "u1"), ("blue", "u1")])
        arr["red"], arr["green"], arr["blue"] = (
            np.clip(colors * 255.0, 0, 255).astype(np.uint8).T)
    else:
        arr = np.empty(n, dtype=[("x", "f4"), ("y", "f4"), ("z", "f4")])
    arr["x"], arr["y"], arr["z"] = vertices.T.astype(np.float32)
    write_ply(path, {"vertex": arr, "face": faces.astype(np.int32)})


def fetch_mesh(path: str):
    """-> (vertices (N,3) f32, faces (M,3) int64, colors (N,3) f32 or None)."""
    d = read_ply(path)
    v = d["vertex"]
    verts = np.stack([v["x"], v["y"], v["z"]], -1).astype(np.float32)
    faces = d.get("face", np.zeros((0, 3), np.int64))
    cols = None
    if v.dtype.names and "red" in v.dtype.names:
        cols = np.stack([v["red"], v["green"], v["blue"]],
                        -1).astype(np.float32) / 255.0
    return verts, faces, cols


# --- Gaussian snapshots ---------------------------------------------------------

def save_gaussian_ply(path: str, xyz, f_dc, f_rest, opacity, scaling, rotation,
                      albedo, roughness, metallic) -> None:
    """All inputs numpy, raw (pre-activation) values. f_dc (N,1,3),
    f_rest (N,K-1,3); the PLY stores them channel-major."""
    n = xyz.shape[0]
    f_dc_flat = np.transpose(f_dc, (0, 2, 1)).reshape(n, -1)
    f_rest_flat = np.transpose(f_rest, (0, 2, 1)).reshape(n, -1)
    names = (["x", "y", "z", "nx", "ny", "nz"]
             + [f"f_dc_{i}" for i in range(f_dc_flat.shape[1])]
             + [f"f_rest_{i}" for i in range(f_rest_flat.shape[1])]
             + ["opacity"] + [f"scale_{i}" for i in range(3)]
             + [f"rot_{i}" for i in range(4)]
             + [f"albedo_{i}" for i in range(3)] + ["roughness", "metallic"])
    mat = np.concatenate([
        xyz, np.zeros_like(xyz), f_dc_flat, f_rest_flat, opacity, scaling,
        rotation, albedo, roughness, metallic], axis=1).astype(np.float32)
    arr = np.empty(n, dtype=[(p, "f4") for p in names])
    for i, p in enumerate(names):
        arr[p] = mat[:, i]
    write_ply(path, {"vertex": arr})


def load_gaussian_ply(path: str) -> dict[str, np.ndarray]:
    """-> dict of raw param arrays: xyz, f_dc (N,1,3), f_rest (N,K-1,3),
    opacity (N,1), scaling (N,3), rotation (N,4), albedo (N,3),
    roughness (N,1), metallic (N,1)."""
    v = read_ply(path)["vertex"]
    n = len(v)
    names = v.dtype.names

    def grab(prefix):
        keys = sorted((p for p in names if p.startswith(prefix)),
                      key=lambda s: int(s.split("_")[-1]))
        return np.stack([v[k] for k in keys], -1).astype(np.float32)

    rest = grab("f_rest_")
    k_rest = rest.shape[1] // 3
    out = {
        "xyz": np.stack([v["x"], v["y"], v["z"]], -1).astype(np.float32),
        "f_dc": grab("f_dc_").reshape(n, 3, 1).transpose(0, 2, 1),
        "f_rest": rest.reshape(n, 3, k_rest).transpose(0, 2, 1),
        "opacity": np.asarray(v["opacity"], np.float32)[:, None],
        "scaling": grab("scale_"),
        "rotation": grab("rot_"),
    }
    if "albedo_0" in names:
        out["albedo"] = grab("albedo_")
        out["roughness"] = np.asarray(v["roughness"], np.float32)[:, None]
        out["metallic"] = np.asarray(v["metallic"], np.float32)[:, None]
    else:  # plain 3DGS PLY: default material logits
        out["albedo"] = np.ones((n, 3), np.float32)
        out["roughness"] = np.ones((n, 1), np.float32)
        out["metallic"] = np.ones((n, 1), np.float32)
    return out
