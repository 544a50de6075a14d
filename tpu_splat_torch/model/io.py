"""Model I/O: PLY snapshots, the env-map sidecars and training
checkpoints (port of tpu_splat/model/io.py; the files are the JAX
package's, byte for byte where the format allows).

The PLY layout is the reference's binary-little-endian one (x,y,z,
nx,ny,nz, f_dc_*, f_rest_* channel-major, opacity, refl, scale_0..1,
rot_0..3); a volumetric state adds scale_2 after scale_1, 3DGS's own
layout, and a PLY with scale_2 loads as a volumetric state. The cubemap
rides beside it twice: `<model>.map.npz` (keys named as the reference
state dict) and the reference's torch `<model>.map`.

A training checkpoint is one `.npz`: `leaf_i`, the JAX `TrainState`'s
leaves in `jax.tree.flatten` order (`model/convert.py:
train_state_leaf_names`), so either package resumes the other's run; the
GaussianState's and the ISP's arrays by name (`g.*`, `isp.*`), for the
render/eval tools; and the port's own generator state, which the JAX
package does not read (its `key` slot holds `jax.random.PRNGKey(0)`).
"""
from __future__ import annotations

import os

import numpy as np
import torch

from tpu_splat_torch.core.device import resolve_device
from tpu_splat_torch.envmap.cubemap import CubemapParams, init_cubemap
from tpu_splat_torch.model.convert import (
    train_state_from_leaves,
    train_state_leaf_names,
    train_state_to_leaves,
)
from tpu_splat_torch.model.state import GaussianState
from tpu_splat_torch.model.torch_pickle import load_torch_state_dict, save_torch_state_dict


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _attribute_names(n_rest: int, n_scale: int) -> list[str]:
    names = ["x", "y", "z", "nx", "ny", "nz"]
    names += [f"f_dc_{i}" for i in range(3)]
    names += [f"f_rest_{i}" for i in range(n_rest * 3)]
    names += ["opacity", "refl"] + [f"scale_{i}" for i in range(n_scale)]
    names += [f"rot_{i}" for i in range(4)]
    return names


def save_ply(state: GaussianState, path: str):
    """The live rows as the reference's PLY, plus both cubemap sidecars."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    alive = _host(state.alive)
    xyz = _host(state.xyz)[alive]
    n = xyz.shape[0]
    # channel-major flatten (reference transpose(1,2).flatten)
    f_dc = _host(state.features_dc)[alive].transpose(0, 2, 1).reshape(n, -1)
    f_rest = _host(state.features_rest)[alive].transpose(0, 2, 1).reshape(n, -1)
    rows = [_host(getattr(state, k))[alive] for k in ("opacity", "refl", "scaling", "rotation")]
    attrs = np.concatenate([xyz, np.zeros_like(xyz), f_dc, f_rest, *rows], axis=1).astype("<f4")
    names = _attribute_names(state.features_rest.shape[1], state.scaling.shape[1])
    if attrs.shape[1] != len(names):
        raise ValueError(f"{attrs.shape[1]} attributes for {len(names)} names")

    header = ["ply", "format binary_little_endian 1.0", f"element vertex {n}"]
    header += [f"property float {a}" for a in names]
    header += ["end_header"]
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        f.write(attrs.tobytes())

    save_envmap(state.env, path.replace(".ply", ".map.npz"))
    save_envmap_torch(state.env, path.replace(".ply", ".map"))


def _envmap_dict(env: CubemapParams) -> dict:
    # reference torch state-dict key names (cubemap_encoder.py:93-96)
    return {
        "params.Cubemap_texture": _host(env.texture).astype(np.float32),
        "params.Cubemap_failv": _host(env.fail_value).astype(np.float32),
    }


def save_envmap(env: CubemapParams, path: str):
    """The cubemap as `.map.npz`."""
    np.savez(path, **_envmap_dict(env))


def save_envmap_torch(env: CubemapParams, path: str):
    """The cubemap as the reference's torch state dict (`.map`, reference
    scene/gaussian_model.py:261-262)."""
    save_torch_state_dict(path, _envmap_dict(env))


def load_envmap(path: str, device: str | torch.device = "cuda") -> CubemapParams:
    """Read a cubemap sidecar: `.map.npz`, or a reference torch `.map`."""
    dev = resolve_device(device)
    if path.endswith(".npz"):
        with np.load(path) as z:
            d = {k: np.asarray(z[k], np.float32) for k in z.files}
    else:
        d = {k: v.astype(np.float32) for k, v in load_torch_state_dict(path).items()}
    return CubemapParams(
        texture=torch.as_tensor(d["params.Cubemap_texture"], device=dev),
        fail_value=torch.as_tensor(d["params.Cubemap_failv"], device=dev),
    )


def _read_ply(path: str):
    with open(path, "rb") as f:
        data = f.read()
    end = data.index(b"end_header\n") + len(b"end_header\n")
    header = data[:end].decode("ascii").splitlines()
    n = None
    names = []
    fmt = None
    for line in header:
        if line.startswith("format"):
            fmt = line.split()[1]
        elif line.startswith("element vertex"):
            n = int(line.split()[-1])
        elif line.startswith("property"):
            _, typ, name = line.split()
            if typ not in ("float", "float32"):
                raise ValueError(f"unsupported property type {typ}")
            names.append(name)
    if fmt != "binary_little_endian":
        raise ValueError(f"unsupported ply format {fmt}")
    arr = np.frombuffer(data[end:], dtype="<f4", count=n * len(names)).reshape(
        n, len(names)
    )
    return {name: arr[:, i] for i, name in enumerate(names)}, n


def load_ply(
    path: str,
    capacity: int | None = None,
    max_sh_degree: int = 3,
    device: str | torch.device = "cuda",
    generator: torch.Generator | None = None,
) -> GaussianState:
    """Load a snapshot (reference load_ply). The env map comes from the
    sidecar when one exists, else it is drawn fresh from `generator`; the
    f_rest count gives the SH degree."""
    dev = resolve_device(device)
    cols, n = _read_ply(path)
    cap = capacity or n

    xyz = np.stack([cols["x"], cols["y"], cols["z"]], axis=1)
    f_dc = np.stack([cols[f"f_dc_{i}"] for i in range(3)], axis=1).reshape(n, 3, 1)
    rest_names = sorted(
        (k for k in cols if k.startswith("f_rest_")),
        key=lambda s: int(s.split("_")[-1]),
    )
    n_rest = len(rest_names) // 3
    sh_deg = int(round((n_rest + 1) ** 0.5)) - 1
    f_rest = np.stack([cols[k] for k in rest_names], axis=1).reshape(n, 3, n_rest)
    opacity = cols["opacity"][:, None]
    refl = cols["refl"][:, None] if "refl" in cols else np.full((n, 1), -4.6)
    scale = np.stack([cols[f"scale_{i}"] for i in range(3 if "scale_2" in cols else 2)], axis=1)
    rot = np.stack([cols[f"rot_{i}"] for i in range(4)], axis=1)

    def pad(a, fill=0.0):
        out = np.full((cap,) + a.shape[1:], fill, dtype=np.float32)
        out[:n] = a
        return out

    rot_p = pad(rot)
    rot_p[n:, 0] = 1.0
    alive = np.zeros(cap, bool)
    alive[:n] = True

    map_path = path.replace(".ply", ".map.npz")
    if not os.path.exists(map_path):
        map_path = path.replace(".ply", ".map")  # reference torch sidecar
    if os.path.exists(map_path):
        env = load_envmap(map_path, device=dev)
    else:
        env = init_cubemap(generator, 3, 128, device=dev)

    t = lambda a: torch.as_tensor(a, device=dev)
    return GaussianState(
        xyz=t(pad(xyz)),
        features_dc=t(pad(f_dc.transpose(0, 2, 1))),
        features_rest=t(pad(f_rest.transpose(0, 2, 1))),
        scaling=t(pad(scale, fill=-10.0)),
        rotation=t(rot_p),
        opacity=t(pad(opacity, fill=-10.0)),
        refl=t(pad(refl, fill=-10.0)),
        env=env,
        alive=t(alive),
        active_sh_degree=sh_deg,
        max_sh_degree=max(sh_deg, max_sh_degree),
    )


# ---------------------------------------------------------------------------
# Training checkpoints

_GAUSSIAN_FIELDS = (
    "xyz", "features_dc", "features_rest", "scaling", "rotation",
    "opacity", "refl", "alive", "active_sh_degree",
)
GENERATOR_KEY = "torch.generator_state"


def save_checkpoint(path: str, train_state, iteration: int):
    """The whole TrainState as one npz (role of chkpntN.pth, reference
    train.py:311-320), laid out as the JAX package writes it; the JAX `key`
    slot holds `PRNGKey(0)`, the generator's own state rides under
    GENERATOR_KEY."""
    leaves = train_state_to_leaves(train_state)
    g = train_state.gaussians
    named = {f"g.{f}": leaves[f"gaussians.{f}"] for f in _GAUSSIAN_FIELDS}
    named["g.env.texture"] = leaves["gaussians.env.texture"]
    named["g.env.fail_value"] = leaves["gaussians.env.fail_value"]
    named["g.max_sh_degree"] = np.asarray(g.max_sh_degree)
    if train_state.isp is not None:
        named.update({k: v for k, v in leaves.items() if k.startswith("isp.")})
    np.savez(
        path,
        __iteration=np.asarray(iteration),
        __n_leaves=np.asarray(len(leaves)),
        **{f"leaf_{i}": v for i, v in enumerate(leaves.values())},
        **named,
        **{GENERATOR_KEY: train_state.generator.get_state().numpy()},
    )


def load_checkpoint(path: str, template_state):
    """-> (TrainState, iteration). The template gives what the file does
    not: the static `max_sh_degree`, the device, and the generator's seed
    when the file holds no generator state (a JAX-written checkpoint)."""
    with np.load(path) as z:
        n = int(z["__n_leaves"])
        has_isp = template_state.isp is not None
        names = train_state_leaf_names(has_isp)
        if n != len(names):
            raise ValueError(f"{path}: {n} leaves, the template has {len(names)}")
        leaves = {k: z[f"leaf_{i}"] for i, k in enumerate(names)}
        gen_state = z[GENERATOR_KEY] if GENERATOR_KEY in z.files else None
        iteration = int(z["__iteration"])
    ts = train_state_from_leaves(leaves, template_state.gaussians.max_sh_degree,
                                 device=template_state.gaussians.device)
    ts.generator.set_state(torch.from_numpy(gen_state) if gen_state is not None
                           else template_state.generator.get_state())
    return ts, iteration


def load_checkpoint_gaussians(path: str, device: str | torch.device = "cuda"
                              ) -> tuple[GaussianState, int]:
    """Restore just the model from a checkpoint (no TrainState template):
    the render/view restore path."""
    dev = resolve_device(device)
    with np.load(path) as z:
        t = lambda k: torch.as_tensor(z[k], device=dev)
        state = GaussianState(
            **{f: t(f"g.{f}") for f in _GAUSSIAN_FIELDS if f != "active_sh_degree"},
            env=CubemapParams(texture=t("g.env.texture"), fail_value=t("g.env.fail_value")),
            active_sh_degree=int(z["g.active_sh_degree"]),
            max_sh_degree=int(z["g.max_sh_degree"]),
        )
        return state, int(z["__iteration"])


def load_checkpoint_isp(path: str, device: str | torch.device = "cuda"):
    """The trained ISP of a checkpoint, or None when the run had none."""
    from tpu_splat_torch.isp.ppisp import ISPParams

    dev = resolve_device(device)
    with np.load(path) as z:
        if "isp.gain" not in z.files:
            return None
        return ISPParams(**{f: torch.as_tensor(z[f"isp.{f}"], device=dev)
                            for f in ISPParams._fields})
