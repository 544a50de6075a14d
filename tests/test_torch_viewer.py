"""The port's viewer (`tpu_splat_torch/viewer/`, `scripts/view.py`,
`scripts/test_rasterizer.py`) against the JAX package's on the CPU.

A loopback client sends the same requests, in every render mode, to the
JAX package's request handler (tpu_splat/scripts/train.py:_service_viewer,
which view.py's loop repeats) and to the port's (service_viewer), each
serving one converted scene. The JAX renderer runs on its Pallas kernels in
interpret mode (backend="pallas", jitted).

Tolerances:
- render_net_image and the uint8 encoder on one RenderOutput: the JAX
  package's float32 image and bytes exactly, in all 11 modes;
- modes that do not read K, against the JAX server's frames: Alpha, Depth,
  Base Color, Refl. Strength, Edge and Mask the same bytes. Normal and
  Curvature come from the normalized blended normal, whose length is at
  most alpha, so the renders' 2e-5 (tests/test_torch_render.py) grows by
  1/alpha there: every byte within 1 level, at most 8 px per 4096 apart,
  where alpha > 0.02 (ALPHA_FLOOR of test_torch_render.py);
- the three modes that read K (RGB, Refl. Color and RGB raw, whose
  reflection reflects the camera rays) against the JAX render_fast on a
  Camera.create camera of the request's pose and fov: every byte within 1
  level, at most 8 px per 4096 apart (the accept flips, PARITY.md D4,
  quantised). The JAX server's own frames there (K = eye) are pinned to
  differ: the port's one documented departure in the viewer.
"""
import json
import socket
import struct
import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tpu_splat.data import orbit_camera, random_scene
from tpu_splat.envmap.cubemap import CubemapParams
from tpu_splat.model.state import GaussianState
from tpu_splat.raster.config import RasterConfig
from tpu_splat.renderer import render_fast
from tpu_splat.viewer import network_gui as jgui

from tpu_splat_torch.model.convert import state_from_numpy
from tpu_splat_torch.raster.config import RasterConfig as TRasterConfig
from tpu_splat_torch.renderer import RenderOutput as TRenderOutput
from tpu_splat_torch.viewer import network_gui as tgui

H, W = 48, 64
N = 150
KW = dict(max_tiles_per_gaussian=16, max_instances=4096, tile_depth=256, chunk=16)
ALPHA_FLOOR = 0.02
K_MODES = ("RGB", "Refl. Color", "RGB raw")
FREE_MODES = tuple(m for m in tgui.RENDER_MODES if m not in K_MODES)
FLIPS_PER_4096 = 8


def _scene_arrays(seed=4):
    raw = random_scene(N, seed=seed, sh_degree=1)
    rng = np.random.default_rng(seed)
    return dict(
        xyz=raw["xyz"], features_dc=raw["sh"][:, :1], features_rest=raw["sh"][:, 1:],
        scaling=raw["scaling"], rotation=raw["rotation"], opacity=raw["opacity"],
        refl=raw["refl"] + 1.5,  # strong reflection: the K fix shows in RGB
        texture=rng.uniform(-2.0, 2.0, (6, 3, 8, 8)).astype(np.float32),
        fail_value=np.zeros(3, np.float32), alive=np.ones(N, bool),
        active_sh_degree=1, max_sh_degree=1,
    )


def _jax_state(d):
    leaves = ("xyz", "features_dc", "features_rest", "scaling", "rotation", "opacity",
              "refl", "alive")
    return GaussianState(
        **{k: jnp.asarray(d[k]) for k in leaves},
        env=CubemapParams(jnp.asarray(d["texture"]), jnp.asarray(d["fail_value"])),
        active_sh_degree=jnp.asarray(d["active_sh_degree"], jnp.int32),
        max_sh_degree=d["max_sh_degree"],
    )


def _recv(sock, n):
    buf = b""
    while len(buf) < n:
        c = sock.recv(n - len(buf))
        assert c, "server closed"
        buf += c
    return buf


def request(sock, width, height, mode_idx, world_view, full_proj, fovx, fovy,
            keep_alive=True):
    """One request in the protocol's convention: the matrices transposed,
    with the columns the server flips pre-flipped."""
    view = np.asarray(world_view, np.float32).T.copy()
    view[:, 1:3] *= -1
    view_proj = np.asarray(full_proj, np.float32).T.copy()
    view_proj[:, 1] *= -1
    header = dict(resolution_x=width, resolution_y=height, train=False, fov_y=fovy,
                  fov_x=fovx, z_near=0.01, z_far=100.0, keep_alive=keep_alive,
                  scaling_modifier=1.0, render_mode=mode_idx)
    payload = json.dumps(header).encode()
    sock.sendall(struct.pack("<I", len(payload)) + payload + view.tobytes()
                 + view_proj.tobytes())


def read_reply(sock, width, height):
    """-> (frame [H,W,3] uint8 or None, source path, metrics)."""
    frame = None
    if width:
        frame = np.frombuffer(_recv(sock, width * height * 3), np.uint8).reshape(height, width, 3)
    (pn,) = struct.unpack("<I", _recv(sock, 4))
    path = _recv(sock, pn).decode()
    (mn,) = struct.unpack("<I", _recv(sock, 4))
    return frame, path, json.loads(_recv(sock, mn).decode())


def read_modes(sock):
    (n,) = struct.unpack("<I", _recv(sock, 4))
    return json.loads(_recv(sock, n).decode())


def _serve(gui, serve_one, requests, cam):
    """A client thread sends `requests` (mode indices, then a control
    message); `serve_one()` answers each on this thread. -> frames."""
    port = gui.listener.getsockname()[1]
    out = {}

    def client():
        s = socket.create_connection(("127.0.0.1", port), timeout=60)
        try:
            out["modes"] = read_modes(s)
            for m in requests:
                request(s, W, H, m, cam.world_view, cam.full_proj, cam.fovx, cam.fovy)
                out[m] = read_reply(s, W, H)
            request(s, 0, 0, 0, np.zeros((4, 4)), np.zeros((4, 4)), 1.0, 1.0)
            out["control"] = read_reply(s, 0, 0)
        finally:
            s.close()

    t = threading.Thread(target=client)
    t.start()
    try:
        gui.listener.settimeout(10.0)  # the first accept waits for the client
        for _ in range(len(requests) + 1):
            serve_one()
    finally:
        t.join(timeout=120)
        gui.close()
    assert not t.is_alive()
    return out


@pytest.fixture(scope="module")
def served():
    from tpu_splat.scripts.train import _service_viewer

    d = _scene_arrays()
    jstate, tstate = _jax_state(d), state_from_numpy(d, device="cpu")
    jcfg = RasterConfig(backend="pallas", **KW)
    tcfg = TRasterConfig(**KW)
    cam = orbit_camera(H, W, radius=4.0, azimuth=0.5, elevation=0.2)
    jit_render = jax.jit(lambda s, c, b: render_fast(s, c, jcfg, b))
    modes = list(range(len(tgui.RENDER_MODES)))

    import tpu_splat.renderer as jren

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jren, "render_fast", lambda s, c, cfg, b, **k: jit_render(s, c, b))
        g = jgui.NetworkGUI(port=0)
        jax_frames = _serve(g, lambda: _service_viewer(g, jstate, jcfg, jnp.zeros(3), "scene", 7),
                            modes, cam)
    g = tgui.NetworkGUI(port=0)
    port_frames = _serve(
        g, lambda: tgui.service_viewer(g, tstate, tcfg, torch.zeros(3), "scene", {"it": 7}),
        modes, cam)
    # the JAX render_fast on the camera the request describes, K from its fov
    want = jit_render(jstate, cam, jnp.zeros(3))
    return dict(jax=jax_frames, port=port_frames, want=want, tstate=tstate, tcfg=tcfg, cam=cam)


def _hold(got, want, alpha=None):
    """Bytes within 1 level, at most FLIPS_PER_4096 px apart (on pixels
    with alpha > ALPHA_FLOOR when alpha is given)."""
    off = np.abs(got.astype(np.int16) - want.astype(np.int16)).max(-1)
    if alpha is not None:
        off = np.where(alpha > ALPHA_FLOOR, off, 0)
    assert off.max() <= 1, int(off.max())
    assert int((off > 0).sum()) <= FLIPS_PER_4096 * off.size / 4096, int((off > 0).sum())


def test_handshake_and_replies_match_jax(served):
    for k in ("jax", "port"):
        assert served[k]["modes"] == tgui.RENDER_MODES == jgui.RENDER_MODES
        assert all(served[k][m][1] == "scene" for m in range(len(tgui.RENDER_MODES)))
    assert served["jax"]["control"] == served["port"]["control"] == (None, "scene", {"it": 7})
    assert served["port"][0][2] == {"it": 7}


@pytest.mark.parametrize("mode", FREE_MODES)
def test_k_free_frames_match_the_jax_server(served, mode):
    i = tgui.RENDER_MODES.index(mode)
    got, want = served["port"][i][0], served["jax"][i][0]
    assert got.shape == (H, W, 3) and got.dtype == np.uint8
    if mode in ("Normal", "Curvature"):
        _hold(got, want, np.asarray(served["want"].alpha)[..., 0])
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mode", K_MODES)
def test_k_frames_match_jax_render_fast_on_camera_create(served, mode):
    """The port's K (from the request's fov) is Camera.create's: its RGB,
    Refl. Color and RGB raw frames are the JAX render_fast's on that
    camera."""
    i = tgui.RENDER_MODES.index(mode)
    out = served["want"]
    img = jgui.render_net_image(out, mode)
    want = (np.clip(img, 0, 1) * 255 + 0.5).astype(np.uint8)
    _hold(served["port"][i][0], want)


def test_jax_viewer_k_eye_departs(served):
    """The JAX server's cameras carry K = eye: its reflection reads rays
    almost parallel to the image plane, so its RGB and Refl. Color frames
    are far from render_fast on the requested camera; the port's are not."""
    want = jgui.render_net_image(served["want"], "Refl. Color")
    want = (np.clip(want, 0, 1) * 255 + 0.5).astype(np.int16)
    i = tgui.RENDER_MODES.index("Refl. Color")
    jax_off = np.abs(served["jax"][i][0].astype(np.int16) - want).max(-1)
    port_off = np.abs(served["port"][i][0].astype(np.int16) - want).max(-1)
    covered = np.asarray(served["want"].alpha)[..., 0] > 0.5
    assert covered.mean() > 0.05
    assert (jax_off[covered] > 8).mean() > 0.5
    assert port_off.max() <= 1


def _random_output(seed=0):
    """One RenderOutput of random maps, as numpy (the JAX side) and as
    tensors (the port)."""
    rng = np.random.default_rng(seed)
    f = lambda c: rng.uniform(0, 1, (H, W, c)).astype(np.float32)
    z = np.zeros((5,), np.float32)
    maps = dict(render=f(3), base_color=f(3), refl_color=f(3), refl_strength=f(1) * 1.2 - 0.1,
                alpha=f(1), normal=f(3) * 2 - 1, dist=f(1), surf_depth=f(1) * 7.0,
                surf_normal=f(3) * 2 - 1, scope_mask=(f(1) > 0.5).astype(np.float32))
    rest = dict(radii=z, gaussian_weights=z, visibility=z > 0, num_instances=np.int32(0),
                max_area=np.int32(0), max_tile_count=np.int32(0), pad_overflow=np.int32(0))
    from tpu_splat.renderer.render import RenderOutput

    j = RenderOutput(**maps, **rest)
    t = TRenderOutput(**{k: torch.from_numpy(np.asarray(v)) for k, v in {**maps, **rest}.items()})
    return j, t


@pytest.mark.parametrize("mode", tgui.RENDER_MODES)
def test_render_net_image_and_encoder_match_jax(mode):
    j, t = _random_output()
    want = jgui.render_net_image(j, mode)
    got = tgui.render_net_image(t, mode)
    assert got.dtype == torch.float32 and got.shape == (H, W, 3)
    np.testing.assert_array_equal(got.numpy(), want)
    # bytes as the JAX send() rounds them (values outside [0, 1] included)
    x = np.concatenate([want.reshape(-1), np.linspace(-0.5, 1.5, 4097, dtype=np.float32)])
    np.testing.assert_array_equal(tgui.encode_u8(torch.from_numpy(x)).numpy(),
                                  (np.clip(x, 0, 1) * 255 + 0.5).astype(np.uint8))


def test_service_viewer_isp_closing_and_resets(served):
    """RGB takes the ISP's controller transform (frame -1) and RGB raw does
    not; a request without keep_alive closes the connection after its
    frame; a client that drops mid-request resets it."""
    from tpu_splat_torch.isp.ppisp import apply_isp, init_isp
    from tpu_splat_torch.renderer import render_fast as t_render_fast

    tstate, tcfg, cam = served["tstate"], served["tcfg"], served["cam"]
    isp = init_isp(2, device="cpu")
    isp = isp._replace(ctrl_gain=isp.ctrl_gain * 1.3, ctrl_bias=isp.ctrl_bias + 0.05)
    g = tgui.NetworkGUI(port=0)
    port = g.listener.getsockname()[1]
    g.listener.settimeout(10.0)
    got = {}

    def client():
        s = socket.create_connection(("127.0.0.1", port), timeout=60)
        read_modes(s)
        for mode in ("RGB", "RGB raw"):
            request(s, W, H, tgui.RENDER_MODES.index(mode), cam.world_view, cam.full_proj,
                    cam.fovx, cam.fovy, keep_alive=mode == "RGB")
            got[mode] = read_reply(s, W, H)[0]
        got["closed"] = s.recv(1) == b""  # the server closed after RGB raw
        s.close()
        s = socket.create_connection(("127.0.0.1", port), timeout=60)
        read_modes(s)
        s.sendall(struct.pack("<I", 100))  # a header announced, never sent
        s.close()

    t = threading.Thread(target=client)
    t.start()
    try:
        served_frames = [tgui.service_viewer(g, tstate, tcfg, torch.zeros(3), "s", {}, isp=isp)
                         for _ in range(2)]
        assert g.conn is None  # closed after the request without keep_alive
        assert not tgui.service_viewer(g, tstate, tcfg, torch.zeros(3), "s", {}, isp=isp)
        assert g.conn is None  # reset after the dropped connection
    finally:
        t.join(timeout=120)
        g.close()
    assert served_frames == [True, True] and got["closed"] and g.closed
    out = t_render_fast(tstate, tgui.viewer_camera(
        dict(width=W, height=H, fovx=cam.fovx, fovy=cam.fovy, znear=0.01, zfar=100.0,
             world_view=np.asarray(cam.world_view), full_proj=np.asarray(cam.full_proj)),
        "cpu"), tcfg, torch.zeros(3), collect_weights=False)
    np.testing.assert_array_equal(got["RGB"], tgui.encode_u8(apply_isp(isp, out.render, -1)).numpy())
    np.testing.assert_array_equal(got["RGB raw"], tgui.encode_u8(out.render).numpy())
    assert not np.array_equal(got["RGB"], got["RGB raw"])


def test_view_cli_serves_until_closed(tmp_path, monkeypatch):
    """scripts/view.py in a thread on an ephemeral port: it answers a
    request with the handler's frame and returns once its server is
    closed."""
    from tpu_splat_torch.config import build_parser, save_cfg_args
    from tpu_splat_torch.model.io import save_ply
    from tpu_splat_torch.renderer import render_fast as t_render_fast
    from tpu_splat_torch.scripts import view
    from tpu_splat_torch.scripts.render import load_iteration

    d = _scene_arrays(5)
    state = state_from_numpy(d, device="cpu")
    model = str(tmp_path / "m")
    save_cfg_args(model, build_parser().parse_args(["-s", str(tmp_path), "-m", model,
                                                    "--sh_degree", "1"]))
    save_ply(state, str(tmp_path / "m" / "point_cloud" / "iteration_3" / "point_cloud.ply"))
    guis = []

    class Recording(tgui.NetworkGUI):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            guis.append(self)

    monkeypatch.setattr(tgui, "NetworkGUI", Recording)
    result = {}
    t = threading.Thread(target=lambda: result.setdefault(
        "rc", view.main(["-m", model, "--port", "0"], device="cpu")))
    t.start()
    try:
        for _ in range(600):
            if guis:
                break
            threading.Event().wait(0.05)
        cam = orbit_camera(H, W, radius=4.0, azimuth=0.2, elevation=0.3)
        s = socket.create_connection(("127.0.0.1", guis[0].listener.getsockname()[1]), timeout=60)
        read_modes(s)
        request(s, W, H, 1, cam.world_view, cam.full_proj, cam.fovx, cam.fovy)
        frame, path, metrics = read_reply(s, W, H)
        s.close()
    finally:
        if guis:
            guis[0].close()
        t.join(timeout=60)
    assert not t.is_alive() and result["rc"] == 0
    assert metrics == {"#": N, "it": 3} and path == str(tmp_path)
    st, _ = load_iteration(model, -1, 1, "cpu")
    out = t_render_fast(st, tgui.viewer_camera(
        dict(width=W, height=H, fovx=cam.fovx, fovy=cam.fovy, znear=0.01, zfar=100.0,
             world_view=np.asarray(cam.world_view), full_proj=np.asarray(cam.full_proj)),
        "cpu"), TRasterConfig(**view.VIEW_CAPS), torch.zeros(3), collect_weights=False)
    np.testing.assert_array_equal(frame, tgui.encode_u8(tgui.render_net_image(out, "Alpha")).numpy())


def test_test_rasterizer_headless_matches_jax(capsys):
    """--headless prints the stage scene's coverage (the cubemap draws
    differ, the alpha does not) and no NaN, as the JAX CLI."""
    from tpu_splat.scripts import test_rasterizer as jtr
    from tpu_splat_torch.scripts import test_rasterizer as ttr

    ttr.main(["--headless"], device="cpu")
    port_line = capsys.readouterr().out.strip().splitlines()[-1]
    with pytest.MonkeyPatch.context() as mp:
        import tpu_splat
        import tpu_splat.raster.config as jrc
        import tpu_splat.renderer as jren

        real = jrc.RasterConfig
        mp.setattr(jrc, "RasterConfig", lambda **k: real(**{"backend": "pallas", **k}))
        mp.setattr(jren, "render_fast", jax.jit(jren.render_fast, static_argnums=(2,)))
        mp.setattr(tpu_splat, "setup_compilation_cache", lambda *a, **k: None)
        jtr.main(["--headless"])
    jax_line = capsys.readouterr().out.strip().splitlines()[-1]
    assert port_line.startswith("stage render: (128, 128, 3), coverage ")
    assert port_line.endswith("nan=False")
    assert float(port_line.split("coverage ")[1].split(",")[0]) > 0.0
    assert port_line == jax_line
