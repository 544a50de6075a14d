"""Training options the port's step reads (a port-owned copy of the fields
of tpu_splat/config.py:OptimizationParams that `train/step.py` uses, with
the same names and defaults: the reference arguments/__init__.py:79-124)."""
from __future__ import annotations

from dataclasses import dataclass


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
    lambda_dssim: float = 0.2
    lambda_normal: float = 0.05
    refl_lr: float = 0.006
    envmap_cubemap_lr: float = 0.05
    init_until_iter: int = 500
    feature_rest_from_iter: int = 7_000
    # freeze xyz + rotation for the last N iterations (reference train.py:
    # 232-233 hardcodes 10_000 of its 40k run)
    freeze_xyz_last_iters: int = 10_000
    disable_normal_consistentcy_loss: bool = False
