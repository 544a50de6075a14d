"""SIBR remote-viewer protocol server (port of
tpu_splat/viewer/network_gui.py; role of reference
gaussian_renderer/network_gui.py + utils/image_utils.py:render_net_image).

Non-blocking TCP listener speaking the same wire protocol: on connect, send a
JSON list of render-mode names; receive() parses a JSON header
{resolution_x/y, train, fov_y/x, z_near/z_far, keep_alive, scaling_modifier,
view_matrix (16 floats), view_projection_matrix (16), render_mode} followed
by flattened matrices; send() streams raw RGB bytes + the source-path string
+ a metrics JSON. Camera matrices arrive in the viewer's (transposed-GLM)
convention with the same axis flips as the reference (network_gui.py:88-91).

The frame is made on the device: render_net_image maps a RenderOutput to
[H,W,3] and encode_u8 rounds it to bytes there, so one uint8 copy crosses
to the host. service_viewer answers one request for every caller (view.py
and test_rasterizer.py through serve, the train CLI once an iteration).

One departure from the JAX package: its viewer cameras carry K = eye(3)
(tpu_splat/scripts/view.py, train.py:_service_viewer, test_rasterizer.py),
and the reflection pass reads the camera rays through K, so every deferred
frame reflects rays that are almost parallel to the image plane.
viewer_camera builds K from the request's fov and frame size, as
Camera.create does.
"""
from __future__ import annotations

import json
import socket
import struct
import time
import traceback

import numpy as np
import torch

RENDER_MODES = [
    # the reference's ten modes (utils/image_utils.py:51-77), served in the
    # same spellings: Edge = surf_normal, Curvature = Sobel gradient of the
    # rendered normal, Mask = env-scope mask
    "RGB",
    "Alpha",
    "Normal",
    "Depth",
    "Base Color",
    "Refl. Strength",
    "Refl. Color",
    "Edge",
    "Curvature",
    "Mask",
    "RGB raw",
]


def _turbo(x: torch.Tensor) -> torch.Tensor:
    """Cheap turbo-like colormap for single-channel maps, [H,W] -> [H,W,3]."""
    x = torch.clamp(x, 0.0, 1.0)
    r = torch.clamp(1.5 - torch.abs(2.0 * x - 1.5), 0, 1)
    g = torch.clamp(1.5 - torch.abs(2.0 * x - 1.0), 0, 1)
    b = torch.clamp(1.5 - torch.abs(2.0 * x - 0.5), 0, 1)
    return torch.stack([r, g, b], dim=-1)


def render_net_image(out, mode: str) -> torch.Tensor:
    """Multiplex a RenderOutput into a viewer image [H,W,3] float in [0,1]
    on its device (role of utils/image_utils.py:51-84), in the JAX
    package's float32 steps."""
    if mode == "Alpha":
        return _turbo(out.alpha[..., 0])
    if mode == "Normal":
        return out.normal * 0.5 + 0.5
    if mode == "Depth":
        d = out.surf_depth[..., 0]
        return _turbo(d / (d.max() + 1e-8))
    if mode == "Base Color":
        return out.base_color
    if mode == "Refl. Strength":
        return _turbo(out.refl_strength[..., 0])
    if mode == "Refl. Color":
        return out.refl_color
    if mode == "Edge":
        # reference 'edge' serves the depth-derived pseudo normal
        # (image_utils.py:70-72)
        return out.surf_normal * 0.5 + 0.5
    if mode == "Curvature":
        from tpu_splat_torch.eval.image_utils import gradient_map

        return _turbo(gradient_map(out.normal * 0.5 + 0.5)[..., 0])
    if mode == "Mask":
        return out.scope_mask.repeat(1, 1, 3)
    return out.render


def encode_u8(image: torch.Tensor) -> torch.Tensor:
    """[H,W,3] float -> uint8 on its device, the bytes of the JAX package's
    `(np.clip(x, 0, 1) * 255 + 0.5).astype(np.uint8)`: a float32 multiply
    and a separate add (two kernels, so no fused multiply-add), then
    truncation."""
    return (torch.clamp(image, 0, 1) * 255.0 + 0.5).to(torch.uint8)


def viewer_camera(cam: dict, device) -> "Camera":
    """The Camera of a parsed request (NetworkGUI.receive): the protocol's
    world_view and full_proj, the projection and K of its fov and frame
    size (K as Camera.create builds it, principal point at W/2, H/2)."""
    from tpu_splat_torch.core.graphics import Camera, fov2focal, projection_from_fov

    H, W = int(cam["height"]), int(cam["width"])
    fx, fy = fov2focal(cam["fovx"], W), fov2focal(cam["fovy"], H)
    K = np.array([[fx, 0, W / 2], [0, fy, H / 2], [0, 0, 1]], dtype=np.float32)
    wv = np.asarray(cam["world_view"], np.float32)
    t = lambda a: torch.tensor(np.asarray(a, np.float32), device=device)
    return Camera(
        world_view=t(wv),
        proj=t(projection_from_fov(cam["znear"], cam["zfar"], cam["fovx"], cam["fovy"])),
        full_proj=t(cam["full_proj"]),
        camera_center=t(np.linalg.inv(wv)[:3, 3]),
        K=t(K),
        height=H,
        width=W,
        fovx=float(cam["fovx"]),
        fovy=float(cam["fovy"]),
        znear=float(cam["znear"]),
        zfar=float(cam["zfar"]),
    )


def service_viewer(gui, state, cfg, bg, source_path: str, metrics: dict, isp=None) -> bool:
    """Answer one pending viewer request (non-blocking accept; reference
    train.py:322-349, tpu_splat/scripts/train.py:_service_viewer): a
    render_fast frame of the requested mode at the requested camera, with
    the ISP's controller transform (frame -1: the viewer's views are
    unknown) on RGB when `isp` is given. A zero-resolution control message
    gets the source path and `metrics` back; a request without keep_alive
    closes the connection after its frame; a dropped connection is reset.
    -> whether a frame was sent."""
    from tpu_splat_torch.renderer import render_fast

    if gui.conn is None:
        gui.try_connect()
        if gui.conn is None:
            return False
    try:
        cam_dict, _train, keep_alive, scale_mod, mode = gui.receive()
        if cam_dict is None:
            gui.send(None, source_path, metrics)
            return False
        cam = viewer_camera(cam_dict, state.device)
        out = render_fast(state, cam, cfg, bg, scaling_modifier=scale_mod,
                          collect_weights=False)
        if isp is not None and RENDER_MODES[mode] == "RGB":
            from tpu_splat_torch.isp.ppisp import apply_isp

            out = out._replace(render=apply_isp(isp, out.render, -1))
        gui.send(encode_u8(render_net_image(out, RENDER_MODES[mode])), source_path, metrics)
        if not keep_alive and gui.conn is not None:
            gui.conn.close()
            gui.conn = None
        return True
    except (ConnectionError, OSError):
        gui.conn = None
        return False


def serve(gui, state, cfg, bg, source_path: str, metrics: dict, isp=None):
    """Answer requests with service_viewer until `gui.close()` (from another
    thread), polling the listener while no viewer is connected; the server
    is closed on the way out."""
    try:
        while not gui.closed:
            if not service_viewer(gui, state, cfg, bg, source_path, metrics, isp=isp) \
                    and gui.conn is None:
                time.sleep(0.005)
    finally:
        gui.close()


class NetworkGUI:
    def __init__(self, host: str = "127.0.0.1", port: int = 6009):
        self.listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        try:
            self.listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            self.listener.bind((host, port))
            self.listener.listen()
        except OSError:
            self.listener.close()
            raise
        self.listener.settimeout(0)
        self.conn = None
        self.addr = None

    @property
    def closed(self) -> bool:
        """True once close() has run: a serving loop ends then."""
        return self.listener.fileno() == -1

    def try_connect(self):
        try:
            self.conn, self.addr = self.listener.accept()
            self.conn.settimeout(None)
            # announce render modes (reference network_gui.py:47-55)
            self._send_json(RENDER_MODES)
        except Exception:
            self.conn = None

    def _read(self, n: int) -> bytes:
        buf = b""
        while len(buf) < n:
            chunk = self.conn.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("viewer disconnected")
            buf += chunk
        return buf

    def _send_json(self, obj):
        payload = json.dumps(obj).encode("utf-8")
        self.conn.sendall(struct.pack("<I", len(payload)) + payload)

    def receive(self):
        """-> (camera_dict | None, do_training, keep_alive, scaling_modifier,
        render_mode)."""
        (n,) = struct.unpack("<I", self._read(4))
        header = json.loads(self._read(n).decode("utf-8"))
        width = header["resolution_x"]
        height = header["resolution_y"]
        if width == 0 or height == 0:
            return None, header.get("train", False), header.get(
                "keep_alive", False
            ), header.get("scaling_modifier", 1.0), header.get("render_mode", 0)
        fovy = header["fov_y"]
        fovx = header["fov_x"]
        znear = header["z_near"]
        zfar = header["z_far"]
        view = np.frombuffer(self._read(4 * 16), np.float32).reshape(4, 4).copy()
        view_proj = np.frombuffer(self._read(4 * 16), np.float32).reshape(4, 4).copy()
        # reference axis flips (network_gui.py:88-91): negate 2nd/3rd columns
        view[:, 1] = -view[:, 1]
        view[:, 2] = -view[:, 2]
        view_proj[:, 1] = -view_proj[:, 1]
        cam = dict(
            width=width, height=height, fovx=fovx, fovy=fovy,
            znear=znear, zfar=zfar,
            world_view=view.T,  # stored transposed in the protocol
            full_proj=view_proj.T,
        )
        return (
            cam,
            header.get("train", False),
            header.get("keep_alive", False),
            header.get("scaling_modifier", 1.0),
            header.get("render_mode", 0),
        )

    def send(self, frame: torch.Tensor | None, source_path: str, metrics: dict):
        """frame: [H,W,3] uint8 on any device (encode_u8), or None -> its raw
        bytes (one copy to the host), then the path and the metrics JSON
        (reference network_gui.py:65-71)."""
        if self.conn is None:
            return
        try:
            if frame is not None:
                self.conn.sendall(frame.cpu().numpy().tobytes())
            path = source_path.encode("utf-8")
            self.conn.sendall(struct.pack("<I", len(path)) + path)
            self._send_json(metrics)
        except Exception:
            traceback.print_exc()
            self.conn = None

    def close(self):
        if self.conn is not None:
            self.conn.close()
        self.listener.close()
