"""Training options the port's step and training loop read (a port-owned
copy of the fields of tpu_splat/config.py:OptimizationParams that
`train/step.py` and `train/loop.py` use, with the same names and defaults:
the reference arguments/__init__.py:79-124)."""
from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class OptimizationParams:
    iterations: int = 40_000
    position_lr_init: float = 0.00016
    position_lr_final: float = 0.0000016
    position_lr_delay_mult: float = 0.01
    position_lr_max_steps: int = 30_000
    feature_lr: float = 0.0025
    opacity_lr: float = 0.05
    scaling_lr: float = 0.005
    rotation_lr: float = 0.001
    percent_dense: float = 0.01
    lambda_dssim: float = 0.2
    lambda_normal: float = 0.05

    densification_interval: int = 100
    opacity_reset_interval: int = 3000
    densify_from_iter: int = 500
    densify_until_iter: int = 15_000
    densify_grad_threshold: float = 0.0002

    refl_lr: float = 0.006
    envmap_cubemap_lr: float = 0.05
    refl_init_value: float = 1e-2
    init_until_iter: int = 500
    feature_rest_from_iter: int = 7_000
    opac_lr0_interval: int = 200
    densification_interval_when_prop: int = 500
    longer_prop_iter: int = 0
    # freeze xyz + rotation for the last N iterations (reference train.py:
    # 232-233 hardcodes 10_000 of its 40k run)
    freeze_xyz_last_iters: int = 10_000

    use_env_scope: bool = False
    env_scope_center: list = field(default_factory=lambda: [0.0, 0.0, 0.0])
    env_scope_radius: float = 0.0

    normal_prop_interval: int = 1000
    normal_prop_until_iter: int = 24_000

    color_sabotage_interval: int = 1000
    color_sabotage_until_iter: int = 24_000

    disable_color_sabotage: bool = False
    disable_normal_propagation: bool = False
    disable_normal_consistentcy_loss: bool = False
