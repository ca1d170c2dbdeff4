"""Port vs JAX package: the SIBR viewer bridge (apps/network_gui.py).

A loopback roundtrip mirroring tests/test_viewer.py, through each
package's NetworkGUI and serve_render on the same Gaussians and the same
request: the port's image bytes within 1 LSB of the JAX package's, the
same verify string and the same do_training; and the port's camera from
the wire bit-equal to the original.
"""
import json
import socket
import threading
import time

import numpy as np
import torch

from gs2m_tpu.apps import network_gui as jgui
from gs2m_tpu_torch.apps import network_gui as tgui

from tests.test_golden import make_camera, make_scene
from tests.test_torch_core import port_gaussians
from tests.test_viewer import viewer_request

torch.set_num_threads(1)

W = H = 32


def roundtrip(module, gaussians, request, **kw):
    """One request from a client thread to `module`'s bridge: -> (image,
    verify string, do_training)."""
    gui = module.NetworkGUI(port=0)
    port = gui.listener.getsockname()[1]
    result = {}

    def client():
        s = socket.create_connection(("127.0.0.1", port))
        msg = json.dumps(request).encode()
        s.sendall(len(msg).to_bytes(4, "little") + msg)
        img = b""
        while len(img) < W * H * 3:
            img += s.recv(W * H * 3 - len(img))
        vlen = int.from_bytes(s.recv(4), "little")
        result["verify"] = s.recv(vlen).decode("ascii")
        result["img"] = np.frombuffer(img, np.uint8).reshape(H, W, 3)
        s.close()

    t = threading.Thread(target=client)
    t.start()
    do_training = None
    for _ in range(200):
        do_training = module.serve_render(gui, gaussians, "srcpath", chunk=32,
                                          instance_cap=2 ** 12, **kw)
        if do_training is not None:
            break
        time.sleep(0.05)
    t.join(timeout=10)
    gui.listener.close()
    return result["img"], result["verify"], do_training


def test_viewer_roundtrip_matches_jax():
    g = make_scene(np.random.default_rng(0), n=40, capacity=64)
    cam = make_camera(width=W, height=H)
    req = viewer_request(cam, W, H)
    j_img, j_verify, j_train = roundtrip(jgui, g, req, backend="xla")
    t_img, t_verify, t_train = roundtrip(tgui, port_gaussians(g), req)
    assert (t_verify, t_train) == (j_verify, j_train) == ("srcpath", True)
    assert t_img.shape == (H, W, 3) and t_img.max() > 0
    assert np.abs(t_img.astype(np.int32) - j_img.astype(np.int32)).max() <= 1


def test_camera_from_viewer_matches_the_original():
    from tests.test_torch_core import camera_pair

    jc, tc = camera_pair(W, H)
    req = viewer_request(jc, W, H)
    wv = np.asarray(req["view_matrix"], np.float32).reshape(4, 4)
    wv[:, 1] *= -1
    wv[:, 2] *= -1
    kw = dict(width=W, height=H, fovx=0.9, fovy=0.9, znear=0.01, zfar=100.0,
              world_view=wv, full_proj=np.asarray(jc.full_proj))
    cam = tgui.camera_from_viewer(kw, "cpu")
    jcam = jgui.camera_from_viewer(kw)
    for name in ("world_view", "full_proj", "cam_center", "fx", "fy", "cx",
                 "cy", "tanfovx", "tanfovy"):
        np.testing.assert_array_equal(getattr(cam, name).numpy(),
                                      np.asarray(getattr(jcam, name)),
                                      err_msg=name)
    np.testing.assert_allclose(cam.world_view.numpy(), tc.world_view.numpy(),
                               atol=1e-6)
    np.testing.assert_allclose(cam.cam_center.numpy(), tc.cam_center.numpy(),
                               atol=1e-5)
    assert (cam.width, cam.height) == (W, H)
