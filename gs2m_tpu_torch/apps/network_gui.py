"""SIBR-viewer TCP bridge: JSON camera in -> raw RGB bytes out.

Port of gs2m_tpu/apps/network_gui.py, with the same wire protocol: a
4-byte little-endian length and a JSON request (resolution, fov, near/far,
the view and view-projection matrices, whose y and z columns the server
flips); the response is the raw HxWx3 uint8 image followed by a
length-prefixed verify string. `serve_render` renders through the port's
render() (kernel K1 on the card, its plain version on the CPU). As in the
JAX package, the bridge does not report the binning's `dropped`: an
overflowing view is sent as rendered.
"""
from __future__ import annotations

import json
import math
import socket
import traceback

import numpy as np
import torch


class NetworkGUI:
    def __init__(self, host: str = "127.0.0.1", port: int = 6009):
        self.listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self.listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.listener.bind((host, port))
        self.listener.listen()
        self.listener.settimeout(0)
        self.conn = None

    def try_connect(self):
        try:
            self.conn, addr = self.listener.accept()
            print(f"\n[>] Viewer connected by {addr}")
            self.conn.settimeout(None)
        except (BlockingIOError, socket.timeout):
            pass

    def _read_exact(self, n: int) -> bytes:
        buf = b""
        while len(buf) < n:
            chunk = self.conn.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("viewer closed")
            buf += chunk
        return buf

    def read(self) -> dict:
        n = int.from_bytes(self._read_exact(4), "little")
        return json.loads(self._read_exact(n).decode("utf-8"))

    def send(self, image_bytes: bytes | None, verify: str):
        if image_bytes is not None:
            self.conn.sendall(image_bytes)
        self.conn.sendall(len(verify).to_bytes(4, "little"))
        self.conn.sendall(bytes(verify, "ascii"))

    def receive(self):
        """-> (camera kwargs or None, do_training, keep_alive, scaling_modifier)."""
        msg = self.read()
        width, height = msg["resolution_x"], msg["resolution_y"]
        if width == 0 or height == 0:
            return None, None, None, None
        wv = np.asarray(msg["view_matrix"], np.float32).reshape(4, 4)
        wv[:, 1] *= -1
        wv[:, 2] *= -1
        fp = np.asarray(msg["view_projection_matrix"], np.float32).reshape(4, 4)
        fp[:, 1] *= -1
        cam = dict(width=width, height=height, fovx=msg["fov_x"],
                   fovy=msg["fov_y"], znear=msg["z_near"],
                   zfar=msg["z_far"], world_view=wv, full_proj=fp)
        return (cam, bool(msg["train"]), bool(msg["keep_alive"]),
                msg["scaling_modifier"])


def camera_from_viewer(cam_kwargs: dict, device=None):
    """The port's Camera built directly from the viewer's (transposed)
    matrices, on `device` (None: the CUDA card; raises without one)."""
    from gs2m_tpu_torch import resolve_device
    from gs2m_tpu_torch.core.camera import Camera

    device = resolve_device(device)

    def f32(x):
        return torch.tensor(np.asarray(x, np.float32), device=device)

    wv = cam_kwargs["world_view"]
    c2w = np.linalg.inv(wv.T)
    w, h = cam_kwargs["width"], cam_kwargs["height"]
    tx, ty = math.tan(cam_kwargs["fovx"] * 0.5), math.tan(cam_kwargs["fovy"] * 0.5)
    return Camera(
        world_view=f32(wv), full_proj=f32(cam_kwargs["full_proj"]),
        cam_center=f32(c2w[:3, 3]),
        fx=f32(w / (2.0 * tx)), fy=f32(h / (2.0 * ty)),
        cx=f32(0.5 * w), cy=f32(0.5 * h), tanfovx=f32(tx), tanfovy=f32(ty),
        width=int(w), height=int(h),
        znear=float(cam_kwargs["znear"]), zfar=float(cam_kwargs["zfar"]))


def serve_render(gui: NetworkGUI, gaussians, source_path: str,
                 chunk: int = 256, instance_cap: int = 2 ** 18, device=None):
    """One request/response cycle (the network_gui loop body of upstream
    3DGS train.py). Renders on `device` (None: the Gaussians' device).
    Returns do_training, or None when idle or when the cycle failed (the
    connection is then dropped, as the JAX package does)."""
    from gs2m_tpu_torch.models.render import render

    if gui.conn is None:
        gui.try_connect()
        return None
    device = gaussians.device if device is None else device
    try:
        cam_kwargs, do_training, keep_alive, scale_mod = gui.receive()
        img_bytes = None
        if cam_kwargs is not None:
            cam = camera_from_viewer(cam_kwargs, device)
            with torch.no_grad():
                pkg = render(gaussians, cam, torch.zeros(3, device=device),
                             gaussians.max_sh_degree, chunk=chunk,
                             instance_cap=instance_cap)
            img = np.clip(pkg["render"].cpu().numpy(), 0, 1)
            img_bytes = memoryview(
                (img.transpose(1, 2, 0) * 255).astype(np.uint8)).tobytes()
        gui.send(img_bytes, source_path)
        return do_training
    except Exception:
        traceback.print_exc()
        gui.conn = None
        return None
