"""The benchmark's inputs, made from the seed: the surfel clouds, the
training views and their ground truth, the viewer's orbit. Frozen copies of
the arithmetic of the port's bench script (`build_state`, `tile_checkpoint`,
`orbit_camera`) and of the NeRF++ scene radius; nothing here imports the
program. A cloud is a dict of raw leaves on the device (the layout of a
2DGS snapshot): xyz [n, 3], features_dc [n, 1, 3], features_rest [n, 15, 3],
scaling [n, 2] (log), rotation [n, 4] (w, x, y, z), opacity and refl [n, 1]
(logits), env_texture [6, 3, L, L], env_fail [3].
"""
from __future__ import annotations

import math
import os

import numpy as np
import torch

SH_C0 = 0.28209479177387814
DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    return g


def synthetic_cloud(scene: dict, seed: int, device) -> dict:
    """The bench cloud: n surface-aligned surfels uniform in [-2, 2]^3 whose
    orientations vary smoothly with position (so reflection lookups are
    coherent, as in a converged scene), log-scales N(mu, sigma), DC colour
    U(0, 1), higher SH bands zero, opacity logits U(-1, 2), reflection logit
    -2.2, the cubemap U(-0.5, 0.5); drawn on the device in a few calls."""
    n, L = scene["n_surfels"], scene["cubemap"]
    g = generator(seed, device)
    u = lambda *s: torch.rand(s, generator=g, device=device)
    nrm = lambda *s: torch.randn(s, generator=g, device=device)
    xyz = 4.0 * u(n, 3) - 2.0
    rot = torch.stack([torch.ones(n, device=device), 0.4 * torch.sin(1.3 * xyz[:, 0]),
                       0.4 * torch.cos(1.1 * xyz[:, 1]), 0.4 * torch.sin(0.9 * xyz[:, 2])], 1)
    rot = rot + 0.05 * nrm(n, 4)
    m = (scene["sh_degree"] + 1) ** 2
    return dict(
        xyz=xyz,
        features_dc=((u(n, 1, 3) - 0.5) / SH_C0),
        features_rest=torch.zeros((n, m - 1, 3), device=device),
        scaling=scene["scale_mu"] + scene["scale_sigma"] * nrm(n, 2),
        rotation=rot,
        opacity=3.0 * u(n, 1) - 1.0,
        refl=torch.full((n, 1), scene["refl_logit"], device=device),
        env_texture=u(6, 3, L, L) - 0.5,
        env_fail=torch.zeros(3, device=device),
    )


def read_ply(path: str) -> dict:
    """Columns of a binary little-endian float32 vertex PLY."""
    with open(path, "rb") as f:
        head = b""
        while not head.endswith(b"end_header\n"):
            head += f.readline()
        names, n = [], 0
        for line in head.decode().splitlines():
            w = line.split()
            if w[:2] == ["element", "vertex"]:
                n = int(w[2])
            elif w[:2] == ["property", "float"]:
                names.append(w[2])
        data = np.frombuffer(f.read(4 * n * len(names)), dtype="<f4").reshape(n, len(names))
    return {k: data[:, i] for i, k in enumerate(names)}


def checkpoint_cloud(scene: dict, seed: int, device) -> dict:
    """A trained snapshot (PLY and env-map sidecar under data/) replicated on
    a jittered grid of rigid offsets (0.55 of its extent apart, so the copies
    overlap like one dense scene) up to n surfels, rescaled into the bench
    camera's view box with the log-scales shifted to match (the bench's
    `tile_checkpoint`, with its fixed jitter: every seed gets the same
    cloud)."""
    cols = read_ply(os.path.join(DATA, scene["ply"]))
    env = np.load(os.path.join(DATA, scene["envmap"]))
    n0 = cols["x"].shape[0]
    target = scene["n_surfels"]
    reps = max(1, int(np.ceil(target / n0)))
    rng = np.random.default_rng(0)
    xyz0 = np.stack([cols["x"], cols["y"], cols["z"]], 1)
    center = xyz0.mean(axis=0)
    extent = (xyz0.max(axis=0) - xyz0.min(axis=0)).max()
    side = int(np.ceil(reps ** (1 / 3)))
    cells = np.stack(np.meshgrid(*[np.arange(side)] * 3, indexing="ij"), -1).reshape(-1, 3)
    offs = (cells[:reps] - cells[:reps].mean(0)) * extent * 0.55
    offs += 0.07 * extent * rng.normal(size=offs.shape)
    xyz = np.concatenate([xyz0 - center + o for o in offs])[:target]
    scale = 2.4 / max(np.abs(xyz).max(), 1e-6)
    xyz = xyz * scale
    n = xyz.shape[0]
    tile = lambda a: np.concatenate([a] * reps)[:n]
    rest = sorted((k for k in cols if k.startswith("f_rest_")), key=lambda s: int(s.split("_")[-1]))
    m1 = len(rest) // 3
    f_rest = np.stack([cols[k] for k in rest], 1).reshape(n0, 3, m1).transpose(0, 2, 1)
    t = lambda a: torch.tensor(np.ascontiguousarray(a, np.float32), device=device)
    return dict(
        xyz=t(xyz),
        features_dc=t(tile(np.stack([cols[f"f_dc_{i}"] for i in range(3)], 1)[:, None, :])),
        features_rest=t(tile(f_rest)),
        scaling=t(tile(np.stack([cols["scale_0"], cols["scale_1"]], 1)) + np.log(scale)),
        rotation=t(tile(np.stack([cols[f"rot_{i}"] for i in range(4)], 1))),
        opacity=t(tile(cols["opacity"][:, None])),
        refl=t(tile(cols["refl"][:, None])),
        env_texture=t(env["params.Cubemap_texture"]),
        env_fail=t(env["params.Cubemap_failv"]),
    )


def cloud(scene: dict, seed: int, device) -> dict:
    kinds = {"synthetic": synthetic_cloud, "checkpoint": checkpoint_cloud}
    return kinds[scene["kind"]](scene, seed, device)


def orbit(height, width, radius, azimuth, elevation, fov):
    """(R camera-to-world, T world-to-view, fovx, fovy) of a camera on a
    sphere about the origin looking at it, OpenCV axes (the port's
    `orbit_camera`)."""
    cam_pos = radius * np.array([math.cos(elevation) * math.sin(azimuth), math.sin(elevation),
                                 math.cos(elevation) * math.cos(azimuth)])
    fwd = -cam_pos / np.linalg.norm(cam_pos)
    right = np.cross(np.array([0.0, -1.0, 0.0]), fwd)
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    R = np.stack([right, down, fwd], axis=1)
    T = -R.T @ cam_pos
    fovy = 2 * math.atan(math.tan(fov / 2) * height / width)
    return R.astype(np.float32), T.astype(np.float32), float(fov), float(fovy)


def train_views(mix: dict, seed: int, height: int, width: int) -> list:
    """The mix's training views: evenly spaced in azimuth on the orbit, each
    jittered by the seed."""
    rng = np.random.default_rng(int(seed))
    n = mix["views"]
    jit = rng.uniform(-mix["azimuth_jitter"], mix["azimuth_jitter"], n)
    return [orbit(height, width, mix["radius"], 2 * math.pi * k / n + jit[k], mix["elevation"],
                  mix["fov"]) for k in range(n)]


def scene_radius(views) -> tuple[float, np.ndarray]:
    """NeRF++ normalisation of the camera centres: (1.1 * the largest
    distance from their mean, the mean)."""
    centers = np.stack([-R @ T for R, T, _, _ in views])
    mean = centers.mean(0)
    return float(np.linalg.norm(centers - mean, axis=-1).max() * 1.1), mean


def ground_truth(seed: int, n: int, height: int, width: int, device) -> list:
    """n uint8 RGB images drawn from the seed, as float32 in [0, 1] (the
    decoded PNGs a dataset holds), on the device."""
    g = generator(seed + 1, device)
    return [torch.randint(0, 256, (height, width, 3), generator=g, device=device,
                          dtype=torch.uint8).float() / 255.0 for _ in range(n)]


def viewer_requests(mix: dict, seed: int, height: int, width: int) -> list:
    """The orbit a viewer flies: `orbit_frames` requests round the scene,
    elevation swinging sinusoidally about `elevation` by `elevation_amp`,
    the phase set by the seed; each as the viewer protocol's camera dict."""
    rng = np.random.default_rng(int(seed))
    phase = rng.uniform(0, 2 * math.pi)
    n = mix["orbit_frames"]
    out = []
    for k in range(n):
        a = 2 * math.pi * k / n + phase
        el = mix["elevation"] + mix["elevation_amp"] * math.sin(2 * a)
        R, T, fovx, fovy = orbit(height, width, mix["radius"], a, el, mix["fov"])
        wv = np.zeros((4, 4), np.float32)
        wv[:3, :3] = R.T
        wv[:3, 3] = T
        wv[3, 3] = 1.0
        tx, ty = math.tan(fovx / 2), math.tan(fovy / 2)
        zn, zf = 0.01, 100.0
        P = np.zeros((4, 4), np.float32)
        P[0, 0], P[1, 1], P[3, 2] = zn / (tx * zn), zn / (ty * zn), 1.0
        P[2, 2] = zf / (zf - zn)
        P[2, 3] = -(zf * zn) / (zf - zn)
        out.append(dict(width=width, height=height, fovx=fovx, fovy=fovy, znear=zn, zfar=zf,
                        world_view=wv.tolist(), full_proj=(P @ wv).tolist()))
    return out
