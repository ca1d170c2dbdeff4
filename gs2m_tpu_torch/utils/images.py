"""Image save/convert helpers for the render app.

Port of gs2m_tpu/utils/images.py (numpy + PIL): PNG export of [0, 1] maps,
RGBA compositing with an alpha mask, the magma depth colormap with
1/99-percentile clipping, camera-space normal export with the
Y-up/Z-back flip, and PSNR.
"""
from __future__ import annotations

import numpy as np

# The 256-entry magma colormap (Smith & van der Walt, CC0), each entry
# floor(255 * rgb) — what an 8-bit export of the listed colormap writes.
_MAGMA_HEX = (
    "00000300000400000601000701010901010b02020d02020f030311040313040415050417"
    "06051907051b08061d09071f0a07220b08240c09260d0a280e0a2a0f0b2c100c2f110c31"
    "120d33140d35150e38160e3a170f3c180f3f1a10411b10441c10461e10491f114b20114d"
    "2211502311522511552611572811592a115c2b115e2d10602f1062301065321067341068"
    "350f6a370f6c390f6e3b0f6f3c0f713e0f72400f73420f74430f75450f76470f77481078"
    "4a10794b10794d117a4f117b50127b52127c53137c55137d57147d58157e5a157e5b167e"
    "5d177e5e177f60187f61187f63197f651a80661a80681b80691c806b1c806c1d806e1e81"
    "6f1e81711f81731f817420817621817721817922817a22817c23817e24817f2481812581"
    "8225818426818526818727818928818a28818c29808d29808f2a80912a80922b80942b80"
    "952c80972c7f992d7f9a2d7f9c2e7f9e2e7e9f2f7ea12f7ea3307ea4307da6317da7317d"
    "a9327cab337cac337bae347bb0347bb1357ab3357ab53679b63679b83778b93778bb3877"
    "bd3977be3976c03a75c23a75c33b74c53c74c63c73c83d72ca3e72cb3e71cd3f70ce4070"
    "d0416fd1426ed3426dd4436dd6446cd7456bd9466ada4769dc4869dd4968de4a67e04b66"
    "e14c66e24d65e44e64e55063e65162e75262e85461ea5560eb5660ec585fed595fee5b5e"
    "ee5d5def5e5df0605df1615cf2635cf3655cf3675bf4685bf56a5bf56c5bf66e5bf6705b"
    "f7715bf7735cf8755cf8775cf9795cf97b5df97d5dfa7f5efa805efa825ffb8460fb8660"
    "fb8861fb8a62fc8c63fc8e63fc9064fc9265fc9366fd9567fd9768fd9969fd9b6afd9d6b"
    "fd9f6cfda16efda26ffda470fea671fea873feaa74feac75feae76feaf78feb179feb37b"
    "feb57cfeb77dfeb97ffebb80febc82febe83fec085fec286fec488fec689fec78bfec98d"
    "fecb8efdcd90fdcf92fdd193fdd295fdd497fdd698fdd89afdda9cfddc9dfddd9ffddfa1"
    "fde1a3fce3a5fce5a6fce6a8fce8aafceaacfcecaefceeb0fcf0b1fcf1b3fcf3b5fcf5b7"
    "fbf7b9fbf9bbfbfabdfbfcbf"
)
MAGMA_U8 = np.frombuffer(bytes.fromhex(_MAGMA_HEX), np.uint8).reshape(256, 3)


def _to_u8(arr: np.ndarray) -> np.ndarray:
    return (np.clip(arr, 0.0, 1.0) * 255).astype(np.uint8)


def save_image(path, img_chw: np.ndarray) -> None:
    """(C, H, W) float [0, 1] -> PNG."""
    from PIL import Image

    arr = np.asarray(img_chw)
    if arr.ndim == 3:
        arr = arr.transpose(1, 2, 0)
        if arr.shape[-1] == 1:
            arr = arr[..., 0]
    Image.fromarray(_to_u8(arr)).save(path)


def save_rgba(path, img_chw: np.ndarray, alpha_1hw: np.ndarray) -> None:
    """(C, H, W) map + (1, H, W) alpha -> RGBA PNG."""
    from PIL import Image

    m = _to_u8(np.asarray(img_chw))
    a = _to_u8(np.asarray(alpha_1hw))
    if m.shape[0] == 1:
        m = np.repeat(m, 3, axis=0)
    rgba = np.concatenate([m, a], 0).transpose(1, 2, 0)
    Image.fromarray(rgba, "RGBA").save(path)


def save_depth_colormap(path, depth_hw: np.ndarray) -> None:
    """Magma colormap with 1/99-percentile normalization -> PNG."""
    from PIL import Image

    d = np.asarray(depth_hw, np.float64)
    lo, hi = np.percentile(d, 1), np.percentile(d, 99)
    normed = np.clip((np.clip(d, lo, hi) - lo) / (hi - lo + 1e-8), 0, 1)
    bad = np.isnan(normed)
    idx = np.clip(np.where(bad, 0, normed * 256).astype(np.int64), 0, 255)
    rgb = np.where(bad[..., None], 0, MAGMA_U8[idx]).astype(np.uint8)
    Image.fromarray(rgb).save(path)


def convert_normal_for_save(normal_chw: np.ndarray, camera,
                            world_space: bool = False) -> np.ndarray:
    """(3, H, W) world normals -> displayable [0, 1] map; camera space gets
    the Y-up/Z-back flip."""
    n = np.asarray(normal_chw).transpose(1, 2, 0).reshape(-1, 3)
    n = n / (np.linalg.norm(n, axis=-1, keepdims=True) + 1e-12)
    if not world_space:
        n = n @ camera.world_view[:3, :3].cpu().numpy()
        n = n * np.array([1.0, -1.0, -1.0])
    n = n * 0.5 + 0.5
    return n.reshape(camera.height, camera.width, 3).transpose(2, 0, 1)


def psnr(img1: np.ndarray, img2: np.ndarray) -> float:
    mse = float(np.mean((np.asarray(img1) - np.asarray(img2)) ** 2))
    return float(20.0 * np.log10(1.0 / np.sqrt(max(mse, 1e-12))))
