"""Model statistics report (port of tpu_splat/scripts/report.py; role of
reference report.py): scale/opacity/refl histograms and distance-vs-size
stats for a trained snapshot. Writes PNGs if matplotlib is available,
always writes stats.json."""
from __future__ import annotations

import json
import os
from argparse import ArgumentParser

import numpy as np


def main(argv=None, device: str = "cuda"):
    """The JAX CLI's flags; `device` is where the snapshot is loaded (the
    tests pass "cpu"); the statistics are numpy, as in the JAX CLI."""
    from tpu_splat_torch.core.device import resolve_device
    from tpu_splat_torch.scripts.render import load_iteration

    parser = ArgumentParser()
    parser.add_argument("--model_path", "-m", required=True)
    parser.add_argument("--iteration", type=int, default=-1)
    args = parser.parse_args(argv)

    state, _ = load_iteration(args.model_path, args.iteration, 3, resolve_device(device))
    host = lambda t: t.cpu().numpy()
    alive = host(state.alive)
    scales = np.exp(host(state.scaling))[alive]
    opa = 1 / (1 + np.exp(-host(state.opacity)[alive, 0]))
    refl = 1 / (1 + np.exp(-host(state.refl)[alive, 0]))
    xyz = host(state.xyz)[alive]
    dist = np.linalg.norm(xyz - xyz.mean(0), axis=-1)

    stats = {
        "n_gaussians": int(alive.sum()),
        "scale_mean": float(scales.mean()),
        "scale_p50": float(np.median(scales)),
        "scale_p99": float(np.percentile(scales, 99)),
        "opacity_mean": float(opa.mean()),
        "opacity_frac_opaque": float((opa > 0.9).mean()),
        "refl_mean": float(refl.mean()),
        "refl_frac_reflective": float((refl > 0.1).mean()),
        "env_resolution": state.env.resolution,
        "dist_size_corr": float(np.corrcoef(dist, scales.max(1))[0, 1]),
    }
    out = os.path.join(args.model_path, "stats.json")
    with open(out, "w") as f:
        json.dump(stats, f, indent=2)
    print(json.dumps(stats, indent=2))

    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, axes = plt.subplots(1, 3, figsize=(12, 3))
        axes[0].hist(np.log10(scales.max(1)), bins=60)
        axes[0].set_title("log10 max scale")
        axes[1].hist(opa, bins=60)
        axes[1].set_title("opacity")
        axes[2].hist(refl, bins=60)
        axes[2].set_title("refl strength")
        fig.tight_layout()
        fig.savefig(os.path.join(args.model_path, "report.png"), dpi=120)
    except Exception:  # matplotlib optional, as in the JAX CLI
        pass


if __name__ == "__main__":
    main()
