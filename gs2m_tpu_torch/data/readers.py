"""Dataset readers: COLMAP scenes and Blender (NeRF-synthetic) transforms.

Port of gs2m_tpu/data/readers.py (numpy + PIL): the same directory
conventions (sparse/0, images/, transforms_{train,test}.json), the every-8th
eval split, the points3D -> PLY cache, the OpenGL -> COLMAP axis flip for
Blender scenes, `*_alpha.png` masks, and cameras_extent = 1.1 x the largest
camera-center distance from their mean. Pixel data is loaded per view by
`load_view_arrays`.
"""
from __future__ import annotations

import json
import math
import os
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from gs2m_tpu_torch.data import colmap as cm
from gs2m_tpu_torch.data.ply import fetch_point_cloud, store_point_cloud


def fov2focal(fov: float, pixels: float) -> float:
    return pixels / (2.0 * math.tan(fov / 2.0))


def focal2fov(focal: float, pixels: float) -> float:
    return 2.0 * math.atan(pixels / (2.0 * focal))


@dataclass
class CameraInfo:
    uid: int
    R: np.ndarray        # transposed w2c rotation (c2w rotation)
    T: np.ndarray        # w2c translation
    fx: float
    fy: float
    width: int           # original image size
    height: int
    image_name: str
    image_path: str
    mask_path: str | None = None
    depth_path: str | None = None


@dataclass
class SceneInfo:
    points: np.ndarray          # (N, 3)
    colors: np.ndarray          # (N, 3) in [0, 1]
    normals: np.ndarray
    train_cameras: list = field(default_factory=list)
    test_cameras: list = field(default_factory=list)
    translate: np.ndarray = None
    radius: float = 1.0         # cameras_extent
    ply_path: str = ""


def nerfpp_norm(cam_infos: list[CameraInfo]):
    """-> (-mean camera center, 1.1 x max distance from it)."""
    centers = np.stack([-(c.R @ c.T) for c in cam_infos], 0)
    center = centers.mean(0)
    diag = np.linalg.norm(centers - center, axis=-1).max()
    return -center, float(diag * 1.1)


def read_colmap_scene(path: str, images: str = "images", masks: str = "",
                      depths: str = "", eval_split: bool = False,
                      llffhold: int = 8) -> SceneInfo:
    sparse = os.path.join(path, "sparse/0")
    if os.path.exists(os.path.join(sparse, "images.bin")):
        extr = cm.read_images_binary(os.path.join(sparse, "images.bin"))
        intr = cm.read_cameras_binary(os.path.join(sparse, "cameras.bin"))
    else:
        extr = cm.read_images_text(os.path.join(sparse, "images.txt"))
        intr = cm.read_cameras_text(os.path.join(sparse, "cameras.txt"))

    image_dir = os.path.join(path, images)
    mask_dir = ""
    if masks:
        mask_dir = masks if os.path.isabs(masks) else os.path.join(path, masks)
    depth_dir = os.path.join(path, depths) if depths else ""

    infos = []
    for im in extr.values():
        cam = intr[im.camera_id]
        if cam.model == "SIMPLE_PINHOLE":
            fx = fy = cam.params[0]
        elif cam.model == "PINHOLE":
            fx, fy = cam.params[0], cam.params[1]
        else:
            raise ValueError(f"Unsupported COLMAP camera model {cam.model}")
        stem = Path(im.name).stem
        infos.append(CameraInfo(
            uid=cam.id, R=cm.qvec_to_rotmat(im.qvec).T, T=im.tvec.copy(),
            fx=float(fx), fy=float(fy), width=cam.width, height=cam.height,
            image_name=im.name, image_path=os.path.join(image_dir, im.name),
            mask_path=os.path.join(mask_dir, f"{stem}.png") if mask_dir else None,
            depth_path=(os.path.join(depth_dir, f"{stem}.png")
                        if depth_dir else None)))
    infos.sort(key=lambda c: c.image_name)

    if eval_split:
        train = [c for i, c in enumerate(infos) if i % llffhold != 0]
        test = [c for i, c in enumerate(infos) if i % llffhold == 0]
    else:
        train, test = infos, []

    translate, radius = nerfpp_norm(train)

    ply_path = os.path.join(sparse, "points3D.ply")
    if not os.path.exists(ply_path):
        if os.path.exists(os.path.join(sparse, "points3D.bin")):
            xyz, rgb, _ = cm.read_points3d_binary(
                os.path.join(sparse, "points3D.bin"))
        else:
            xyz, rgb, _ = cm.read_points3d_text(
                os.path.join(sparse, "points3D.txt"))
        store_point_cloud(ply_path, xyz, rgb)
    pts, cols, normals = fetch_point_cloud(ply_path)

    return SceneInfo(points=pts, colors=cols, normals=normals,
                     train_cameras=train, test_cameras=test,
                     translate=translate, radius=radius, ply_path=ply_path)


def _read_transforms(path: str, transforms_file: str, depth_dir: str,
                     extension: str = ".png") -> list[CameraInfo]:
    from PIL import Image

    with open(os.path.join(path, transforms_file)) as f:
        contents = json.load(f)
    fovx = contents["camera_angle_x"]

    infos = []
    for idx, frame in enumerate(contents["frames"]):
        rel = frame["file_path"] + extension
        image_path = os.path.join(path, rel)
        c2w = np.array(frame["transform_matrix"], np.float64)
        c2w[:3, 1:3] *= -1  # OpenGL (Y up, Z back) -> COLMAP (Y down, Z fwd)
        w2c = np.linalg.inv(c2w)
        with Image.open(image_path) as img:
            w, h = img.size
        focal = fov2focal(fovx, w)
        stem = Path(rel).stem
        split = "train" if "train" in rel else "test"
        mask_path = os.path.join(path, split, f"{stem}_alpha.png")
        infos.append(CameraInfo(
            uid=idx, R=w2c[:3, :3].T, T=w2c[:3, 3], fx=focal, fy=focal,
            width=w, height=h, image_name=Path(rel).name,
            image_path=image_path,
            mask_path=mask_path if os.path.exists(mask_path) else None,
            depth_path=(os.path.join(depth_dir, split, f"{stem}.png")
                        if depth_dir else None)))
    return infos


def read_blender_scene(path: str, depths: str = "", eval_split: bool = False,
                       extension: str = ".png") -> SceneInfo:
    depth_dir = os.path.join(path, depths) if depths else ""
    train = _read_transforms(path, "transforms_train.json", depth_dir, extension)
    test = _read_transforms(path, "transforms_test.json", depth_dir, extension)
    if not eval_split:
        train = train + test
        test = []

    translate, radius = nerfpp_norm(train)

    ply_path = os.path.join(path, "points3d.ply")
    if not os.path.exists(ply_path):
        # Random init inside the Blender scene bounds.
        num_pts = 100_000
        xyz = np.random.random((num_pts, 3)) * 2.6 - 1.3
        shs = np.random.random((num_pts, 3)) / 255.0
        cols = shs * 0.28209479177387814 + 0.5
        store_point_cloud(ply_path, xyz, cols * 255)
    pts, cols, normals = fetch_point_cloud(ply_path)

    return SceneInfo(points=pts, colors=cols, normals=normals,
                     train_cameras=train, test_cameras=test,
                     translate=translate, radius=radius, ply_path=ply_path)


def detect_and_read_scene(source_path: str, images: str = "images",
                          masks: str = "", depths: str = "",
                          eval_split: bool = False) -> SceneInfo:
    """Scene-type sniffing: COLMAP (sparse/) or Blender (transforms_*.json)."""
    if os.path.exists(os.path.join(source_path, "sparse")):
        return read_colmap_scene(source_path, images, masks, depths, eval_split)
    if os.path.exists(os.path.join(source_path, "transforms_train.json")):
        return read_blender_scene(source_path, depths, eval_split)
    raise ValueError(f"Could not recognize scene type at {source_path}")


# --- per-view pixel data -----------------------------------------------------------

def pick_resolution(orig_w: int, orig_h: int, resolution: int,
                    resolution_scale: float = 1.0) -> tuple[int, int]:
    """-r semantics: 1/2/4/8 divide; -1 caps width at 1600; other values
    set the target width."""
    if resolution in (1, 2, 4, 8):
        s = resolution_scale * resolution
        return round(orig_w / s), round(orig_h / s)
    if resolution == -1:
        down = orig_w / 1600 if orig_w > 1600 else 1
    else:
        down = orig_w / resolution
    s = float(down) * float(resolution_scale)
    return int(orig_w / s), int(orig_h / s)


def load_view_arrays(info: CameraInfo, resolution: tuple[int, int],
                     mask_gt: bool = False):
    """-> (rgb (3,H,W) f32 in [0,1], alpha (1,H,W) f32 or None): RGBA alpha
    or the provided mask; optional GT masking BEFORE resize; PIL bilinear
    resize."""
    from PIL import Image

    image = Image.open(info.image_path)
    alpha_img = Image.open(info.mask_path).convert("L") if info.mask_path else None
    if image.mode == "RGBA":
        r, g, b, a = image.split()
        image = Image.merge("RGB", (r, g, b))
        if alpha_img is None:
            alpha_img = a

    if mask_gt and alpha_img is not None:
        rgb_np = np.array(image)[..., :3].astype(np.float32)
        a_np = np.array(alpha_img).astype(np.float32)[..., None]
        masked = np.clip(rgb_np / 255.0 * (a_np / max(a_np.max(), 1e-8)), 0, 1)
        image = Image.fromarray((masked * 255).astype(np.uint8))

    image = image.resize(resolution)
    rgb = np.asarray(image, np.float32) / 255.0
    if rgb.ndim == 2:
        rgb = rgb[..., None]
    rgb = rgb.transpose(2, 0, 1)[:3]

    alpha = None
    if alpha_img is not None:
        a = np.asarray(alpha_img.resize(resolution), np.float32)
        alpha = (a / max(a.max(), 1e-8))[None]
    return rgb, alpha
