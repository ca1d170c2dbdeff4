"""COLMAP sparse-reconstruction parsers and writers (binary and text).

Port of gs2m_tpu/data/colmap.py (numpy only): cameras.{bin,txt},
images.{bin,txt}, points3D.{bin,txt}, following COLMAP's documented file
layout.
"""
from __future__ import annotations

import os
import struct
from dataclasses import dataclass

import numpy as np

# model_id -> (name, num_params); COLMAP's camera model table.
CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3), 1: ("PINHOLE", 4), 2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5), 4: ("OPENCV", 8), 5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12), 7: ("FOV", 5), 8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5), 10: ("THIN_PRISM_FISHEYE", 12),
}
MODEL_NAME_TO_ID = {name: mid for mid, (name, _) in CAMERA_MODELS.items()}


@dataclass
class ColmapCamera:
    id: int
    model: str
    width: int
    height: int
    params: np.ndarray


@dataclass
class ColmapImage:
    id: int
    qvec: np.ndarray  # (4,) w x y z
    tvec: np.ndarray  # (3,)
    camera_id: int
    name: str


def qvec_to_rotmat(q: np.ndarray) -> np.ndarray:
    """(4,) w x y z -> (3,3) rotation (same convention as COLMAP)."""
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def rotmat_to_qvec(R: np.ndarray) -> np.ndarray:
    """(3,3) -> (4,) w x y z via the symmetric eigen method."""
    Rxx, Ryx, Rzx, Rxy, Ryy, Rzy, Rxz, Ryz, Rzz = R.flat
    K = np.array([
        [Rxx - Ryy - Rzz, 0, 0, 0],
        [Ryx + Rxy, Ryy - Rxx - Rzz, 0, 0],
        [Rzx + Rxz, Rzy + Ryz, Rzz - Rxx - Ryy, 0],
        [Ryz - Rzy, Rzx - Rxz, Rxy - Ryx, Rxx + Ryy + Rzz]]) / 3.0
    vals, vecs = np.linalg.eigh(K)
    q = vecs[[3, 0, 1, 2], np.argmax(vals)]
    return -q if q[0] < 0 else q


def _read(f, n, fmt):
    return struct.unpack("<" + fmt, f.read(n))


def read_cameras_binary(path: str) -> dict[int, ColmapCamera]:
    cams = {}
    with open(path, "rb") as f:
        (n,) = _read(f, 8, "Q")
        for _ in range(n):
            cid, model_id, w, h = _read(f, 24, "iiQQ")
            name, n_params = CAMERA_MODELS[model_id]
            params = np.array(_read(f, 8 * n_params, "d" * n_params))
            cams[cid] = ColmapCamera(cid, name, int(w), int(h), params)
    return cams


def read_cameras_text(path: str) -> dict[int, ColmapCamera]:
    cams = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            cid = int(parts[0])
            cams[cid] = ColmapCamera(cid, parts[1], int(parts[2]), int(parts[3]),
                                     np.array([float(x) for x in parts[4:]]))
    return cams


def read_images_binary(path: str) -> dict[int, ColmapImage]:
    imgs = {}
    with open(path, "rb") as f:
        (n,) = _read(f, 8, "Q")
        for _ in range(n):
            iid = _read(f, 4, "i")[0]
            vals = _read(f, 56, "d" * 7)
            cam_id = _read(f, 4, "i")[0]
            name = b""
            while True:
                c = f.read(1)
                if c == b"\x00":
                    break
                name += c
            (n_pts,) = _read(f, 8, "Q")
            f.seek(24 * n_pts, os.SEEK_CUR)  # skip 2D points (x, y, point3D_id)
            imgs[iid] = ColmapImage(iid, np.array(vals[:4]), np.array(vals[4:]),
                                    cam_id, name.decode("utf-8"))
    return imgs


def read_images_text(path: str) -> dict[int, ColmapImage]:
    imgs = {}
    with open(path) as f:
        lines = [ln.strip() for ln in f if ln.strip() and not ln.startswith("#")]
    for header in lines[0::2]:
        parts = header.split()
        iid = int(parts[0])
        q = np.array([float(x) for x in parts[1:5]])
        t = np.array([float(x) for x in parts[5:8]])
        imgs[iid] = ColmapImage(iid, q, t, int(parts[8]), parts[9])
    return imgs


def read_points3d_binary(path: str):
    """-> (xyz (N,3) f64, rgb (N,3) u8, error (N,) f64)."""
    with open(path, "rb") as f:
        data = f.read()
    (n,) = struct.unpack_from("<Q", data, 0)
    xyz = np.empty((n, 3))
    rgb = np.empty((n, 3), np.uint8)
    err = np.empty(n)
    off = 8
    for i in range(n):
        xyz[i] = struct.unpack_from("<3d", data, off + 8)
        rgb[i] = struct.unpack_from("<3B", data, off + 32)
        (err[i],) = struct.unpack_from("<d", data, off + 35)
        (track_len,) = struct.unpack_from("<Q", data, off + 43)
        off += 51 + 8 * track_len
    return xyz, rgb, err


def read_points3d_text(path: str):
    xyz, rgb, err = [], [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            p = line.split()
            xyz.append([float(v) for v in p[1:4]])
            rgb.append([int(v) for v in p[4:7]])
            err.append(float(p[7]))
    return (np.asarray(xyz, np.float64), np.asarray(rgb, np.uint8),
            np.asarray(err, np.float64))


def write_cameras_binary(path: str, cams: dict[int, ColmapCamera]) -> None:
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(cams)))
        for c in cams.values():
            f.write(struct.pack("<iiQQ", c.id, MODEL_NAME_TO_ID[c.model],
                                c.width, c.height))
            f.write(struct.pack("<" + "d" * len(c.params), *c.params))


def write_images_binary(path: str, imgs: dict[int, ColmapImage]) -> None:
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(imgs)))
        for im in imgs.values():
            f.write(struct.pack("<i", im.id))
            f.write(struct.pack("<7d", *im.qvec, *im.tvec))
            f.write(struct.pack("<i", im.camera_id))
            f.write(im.name.encode("utf-8") + b"\x00")
            f.write(struct.pack("<Q", 0))  # no 2D points


def write_points3d_binary(path: str, xyz: np.ndarray, rgb: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", xyz.shape[0]))
        for i in range(xyz.shape[0]):
            f.write(struct.pack("<Q", i))
            f.write(struct.pack("<3d", *xyz[i]))
            f.write(struct.pack("<3B", *np.asarray(rgb[i], np.uint8)))
            f.write(struct.pack("<d", 0.0))
            f.write(struct.pack("<Q", 0))  # empty track
