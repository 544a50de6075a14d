"""LPIPS metric (port of tpu_splat/eval/lpips.py; role of reference
lpipsPyTorch/).

The reference vendors an LPIPS implementation whose quality depends on
pretrained VGG features + linear heads downloaded at runtime
(lpipsPyTorch/modules/lpips.py). Nothing is downloaded here, so pretrained
weights are only usable if already on disk. We provide:
- lpips_fn_or_none(): an `LpipsVgg` module on the caller's device if the
  torchvision VGG16 weights and the LPIPS lin heads are on disk (TORCH_HOME,
  LPIPS_WEIGHTS), else None — metrics report NaN for LPIPS then, with
  PSNR/SSIM always available.
- gmsd(): a WEIGHT-FREE perceptual fallback (Gradient Magnitude Similarity
  Deviation, Xue et al. 2014) reported alongside LPIPS so the quality triple
  never silently degrades to two numbers. Lower is better, like LPIPS. It
  stays numpy, with the JAX package's arithmetic.
"""
from __future__ import annotations

import os
import pickle

import numpy as np
import torch
import torch.nn.functional as F

from tpu_splat_torch.core.device import full_precision_matmul, resolve_device


def gmsd(a, b) -> float:
    """Gradient Magnitude Similarity Deviation between two [H,W,3] images in
    [0,1]. Weight-free perceptual distance: Prewitt gradient magnitudes on a
    2x-downsampled luminance channel, per-pixel similarity, then its std.
    Serves as the LPIPS stand-in when no pretrained backbone exists on
    disk. Takes numpy arrays or tensors on any device."""
    a, b = (x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x for x in (a, b))
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    # luminance in [0,255] like the original formulation (c tuned for it)
    ya = 255.0 * (0.299 * a[..., 0] + 0.587 * a[..., 1] + 0.114 * a[..., 2])
    yb = 255.0 * (0.299 * b[..., 0] + 0.587 * b[..., 1] + 0.114 * b[..., 2])
    # 2x average-pool downsample (paper's preprocessing)
    h, w = ya.shape
    h2, w2 = h - h % 2, w - w % 2
    ya = ya[:h2, :w2].reshape(h2 // 2, 2, w2 // 2, 2).mean(axis=(1, 3))
    yb = yb[:h2, :w2].reshape(h2 // 2, 2, w2 // 2, 2).mean(axis=(1, 3))

    kx = np.array([[1, 0, -1], [1, 0, -1], [1, 0, -1]], np.float32) / 3.0
    ky = kx.T

    def grad_mag(y):
        yp = np.pad(y, 1, mode="edge")
        gx = sum(
            kx[i, j] * yp[i : i + y.shape[0], j : j + y.shape[1]]
            for i in range(3)
            for j in range(3)
            if kx[i, j] != 0
        )
        gy = sum(
            ky[i, j] * yp[i : i + y.shape[0], j : j + y.shape[1]]
            for i in range(3)
            for j in range(3)
            if ky[i, j] != 0
        )
        return np.sqrt(gx * gx + gy * gy)

    ma, mb = grad_mag(ya), grad_mag(yb)
    c = 170.0
    gms = (2.0 * ma * mb + c) / (ma * ma + mb * mb + c)
    return float(np.std(gms))


# ---------------------------------------------------------------------------
# Calibrated LPIPS (exact reference structure, lpipsPyTorch/modules/lpips.py):
# VGG16 feature stack (torchvision layout, taps after relu{1_2,2_2,3_3,4_3,
# 5_3} = module indices 4/9/16/23/30 1-based), per-layer channel-unit
# normalization (utils.py normalize_activation, eps 1e-10), squared feature
# difference, pretrained 1x1 "lin" head per layer (networks.py LinLayers),
# spatial mean, sum over layers. Inputs are fed in [0,1] exactly as the
# reference metrics.py does (z_score shift/scale constants from
# networks.py BaseNet: mean [-.030,-.088,-.188], std [.458,.448,.450]).
#
# Weights come from LOCAL files only:
#   - VGG16 backbone: $TORCH_HOME/hub/checkpoints/vgg16-*.pth (torchvision
#     checkpoint format).
#   - lin heads: $LPIPS_WEIGHTS, or $TORCH_HOME/hub/checkpoints/ containing
#     a file named *lpips*vgg*.pth / vgg.pth with richzhang
#     PerceptualSimilarity v0.1 keys ("lin0.model.1.weight", ...).
# Without BOTH, lpips_fn_or_none() returns None — metrics report NaN for
# LPIPS plus the weight-free GMSD, never an uncalibrated lookalike number.

# VGG16 "features" conv plan: (out_channels per conv, 'M' = 2x2 maxpool)
_VGG16_PLAN = (64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
               512, 512, 512, "M", 512, 512, 512, "M")
# 1-based module indices after which LPIPS taps features (conv+relu pairs
# interleaved with pools; networks.py VGG16.target_layers)
_VGG16_TAPS = (4, 9, 16, 23, 30)
_LPIPS_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_LPIPS_SCALE = np.array([0.458, 0.448, 0.450], np.float32)


def _torch_home_ckpts() -> str:
    home = os.environ.get("TORCH_HOME", os.path.expanduser("~/.cache/torch"))
    return os.path.join(home, "hub", "checkpoints")


def _find_vgg16_weights() -> str | None:
    hub = _torch_home_ckpts()
    if not os.path.isdir(hub):
        return None
    for f in sorted(os.listdir(hub)):
        if f.startswith("vgg16-") and f.endswith(".pth"):
            return os.path.join(hub, f)
    return None


def _find_lin_weights() -> str | None:
    env = os.environ.get("LPIPS_WEIGHTS")
    if env and os.path.isfile(env):
        return env
    hub = _torch_home_ckpts()
    if not os.path.isdir(hub):
        return None
    for f in sorted(os.listdir(hub)):
        lf = f.lower()
        if lf.endswith(".pth") and ("lpips" in lf and "vgg" in lf or lf == "vgg.pth"):
            return os.path.join(hub, f)
    return None


def _load_torch_state_dict(path: str) -> dict:
    """A torch checkpoint as {name: CPU float32 tensor}."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return {k: torch.as_tensor(v, dtype=torch.float32) for k, v in sd.items()}


class LpipsVgg(torch.nn.Module):
    """Exact-structure LPIPS-vgg (the JAX package's `_LpipsVgg`) as a
    module on `device`: `F.conv2d` and `F.max_pool2d` in float32, TF32
    off. Called on two [H,W,3] images in [0,1] (tensors or arrays), it
    returns the distance as a 0-d tensor."""

    def __init__(self, vgg_sd: dict, lin_sd: dict, device: str | torch.device = "cuda"):
        super().__init__()
        dev = resolve_device(device)
        t = lambda v: torch.as_tensor(np.asarray(v, np.float32), device=dev)
        # torchvision module indexing: convs sit at even offsets between
        # relus, pools occupy one slot each
        idx, weights, biases = 0, [], []
        for spec in _VGG16_PLAN:
            if spec == "M":
                idx += 1
                continue
            weights.append(t(vgg_sd[f"features.{idx}.weight"]))
            biases.append(t(vgg_sd[f"features.{idx}.bias"]))
            idx += 2  # conv + relu
        # lin heads: richzhang v0.1 keys after the reference's renaming
        # (get_state_dict strips "lin"/"model."): "0.1.weight" ... — accept
        # both the raw ("lin0.model.1.weight") and renamed spellings
        lins = []
        for li in range(5):
            for key in (f"lin{li}.model.1.weight", f"{li}.1.weight",
                        f"lin{li}.weight", f"{li}.weight"):
                if key in lin_sd:
                    lins.append(t(lin_sd[key]).reshape(1, -1, 1, 1))
                    break
            else:
                raise KeyError(f"lin head {li} not found in LPIPS weights")
        for name, seq in (("conv_w", weights), ("conv_b", biases), ("lin", lins)):
            for i, v in enumerate(seq):
                self.register_buffer(f"{name}{i}", v)
        self.register_buffer("shift", t(_LPIPS_SHIFT).reshape(1, 3, 1, 1))
        self.register_buffer("scale", t(_LPIPS_SCALE).reshape(1, 3, 1, 1))
        full_precision_matmul()

    def features(self, x: torch.Tensor) -> list[torch.Tensor]:
        """x [1,3,H,W] in [0,1] -> the five unit-normalized taps."""
        x = (x - self.shift) / self.scale
        out = []
        module_idx, ci = 1, 0
        for spec in _VGG16_PLAN:
            if spec == "M":
                x = F.max_pool2d(x, 2, 2)
                module_idx += 1
            else:
                w, b = getattr(self, f"conv_w{ci}"), getattr(self, f"conv_b{ci}")
                ci += 1
                x = torch.relu(F.conv2d(x, w, b, padding=1))
                module_idx += 2
            if (module_idx - 1) in _VGG16_TAPS:
                n = torch.sqrt(torch.sum(x * x, dim=1, keepdim=True))
                out.append(x / (n + 1e-10))
            if len(out) == len(_VGG16_TAPS):
                break
        return out

    @torch.no_grad()
    def forward(self, a, b) -> torch.Tensor:
        dev = self.shift.device
        x, y = (torch.as_tensor(v, dtype=torch.float32, device=dev).permute(2, 0, 1)[None]
                for v in (a, b))
        total = torch.zeros((), device=dev)
        for i, (fa, fb) in enumerate(zip(self.features(x), self.features(y))):
            # 1x1 conv with weight [1,C,1,1] == channel-weighted sum
            r = torch.sum((fa - fb) ** 2 * getattr(self, f"lin{i}"), dim=1)
            total = total + torch.mean(r)
        return total


def lpips_fn_or_none(net: str = "vgg", device: str | torch.device = "cuda"):
    """Calibrated LPIPS-vgg module on `device`, or None when the pretrained
    VGG16 backbone or the LPIPS lin heads are not on disk (or do not load
    as such). Raises when `device` is CUDA and there is none."""
    dev = resolve_device(device)
    vgg_path = _find_vgg16_weights()
    lin_path = _find_lin_weights()
    if vgg_path is None or lin_path is None:
        return None
    try:
        return LpipsVgg(_load_torch_state_dict(vgg_path), _load_torch_state_dict(lin_path),
                        device=dev)
    except (KeyError, RuntimeError, OSError, ValueError, pickle.UnpicklingError):
        return None
