"""Config / flag system (port of tpu_splat/config.py; role of the
reference arguments/__init__.py).

Dataclass-reflection argparse groups with the same flag names, defaults and
shorthand conventions as the reference ParamGroup (a name in `_shorthand`
also gets a one-letter alias), plus the persisted `cfg_args` round trip that
makes a model directory self-describing (reference get_combined_args,
arguments/__init__.py:126-146; written by train.py:362-363). A `cfg_args`
written by either package merges in the other's `get_combined_args`. The
positive spellings used by the orchestration scripts (--normal_propagation
etc., scene_args.yaml:13) are accepted as aliases of the disable_* kill
switches. `ModelParams.data_device` defaults to "cuda", the reference's
default: the ground-truth images live there.
"""
from __future__ import annotations

import dataclasses
import os
from argparse import ArgumentParser, Namespace
from dataclasses import dataclass, field, fields


class _Group:
    _shorthand: tuple[str, ...] = ()

    @classmethod
    def add_to_parser(cls, parser: ArgumentParser, fill_none: bool = False):
        group = parser.add_argument_group(cls.__name__)
        for f in fields(cls):
            default = None if fill_none else f.default_factory() if callable(
                getattr(f, "default_factory", None)
            ) and f.default_factory is not dataclasses.MISSING else (
                None if fill_none else f.default
            )
            names = ["--" + f.name]
            if f.name in cls._shorthand:
                names.append("-" + f.name[0])
            t = f.type if isinstance(f.type, type) else type(f.default)
            if t is bool:
                group.add_argument(*names, default=default, action="store_true")
            elif t is list or isinstance(f.default, list) or (
                f.default_factory is not dataclasses.MISSING
                if hasattr(f, "default_factory")
                else False
            ):
                group.add_argument(*names, default=default, nargs="+", type=float)
            elif t is int:
                group.add_argument(*names, default=default, type=int)
            elif t is float:
                group.add_argument(*names, default=default, type=float)
            else:
                group.add_argument(*names, default=default, type=str)

    @classmethod
    def extract(cls, args: Namespace):
        kwargs = {}
        for f in fields(cls):
            if hasattr(args, f.name) and getattr(args, f.name) is not None:
                kwargs[f.name] = getattr(args, f.name)
        return cls(**kwargs)


@dataclass
class ModelParams(_Group):
    """Reference ModelParams (arguments/__init__.py:51-69)."""

    _shorthand = ("source_path", "model_path", "images", "resolution", "white_background")

    sh_degree: int = 3
    source_path: str = ""
    model_path: str = ""
    images: str = "images"
    resolution: int = -1
    white_background: bool = False
    cubemap_resol: int = 128
    data_device: str = "cuda"  # where the ground-truth images live (the reference's default)
    eval: bool = False
    num_points: int = 100_000
    post_process: bool = True  # learned ISP post-processing (PPISP role)

    def finalize(self):
        if self.source_path:
            self.source_path = os.path.abspath(self.source_path)
        return self


@dataclass
class PipelineParams(_Group):
    """Reference PipelineParams (arguments/__init__.py:71-77)."""

    convert_SHs_python: bool = False
    compute_cov3D_python: bool = False
    depth_ratio: float = 0.0
    debug: bool = False


@dataclass
class OptimizationParams(_Group):
    """Reference OptimizationParams (arguments/__init__.py:79-124), same
    defaults — these constants define the fork's training schedule."""

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
    opacity_cull: float = 0.05

    densification_interval: int = 100
    opacity_reset_interval: int = 3000
    densify_from_iter: int = 500
    densify_until_iter: int = 15_000
    densify_grad_threshold: float = 0.0002

    refl_lr: float = 0.006
    envmap_cubemap_lr: float = 0.05
    refl_init_value: float = 1e-2
    lambda_refl_smooth: float = 0.4
    init_until_iter: int = 500
    feature_rest_from_iter: int = 7_000
    opac_lr0_interval: int = 200
    densification_interval_when_prop: int = 500
    longer_prop_iter: int = 0
    # freeze xyz+rotation for the last N iterations (reference train.py:
    # 232-233 hardcodes 10_000 of its 40k default run — on shorter
    # schedules that would freeze geometry for the WHOLE run, so it is a
    # parameter here; the default reproduces the reference)
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


def build_parser(fill_none_model: bool = False) -> ArgumentParser:
    parser = ArgumentParser()
    ModelParams.add_to_parser(parser, fill_none=fill_none_model)
    PipelineParams.add_to_parser(parser)
    OptimizationParams.add_to_parser(parser)
    # positive aliases for the disable_* kill switches (scene_args.yaml:13)
    parser.add_argument("--normal_propagation", action="store_true", default=None)
    parser.add_argument("--color_sabotage", action="store_true", default=None)
    parser.add_argument("--random_background_color", action="store_true", default=None)
    return parser


def save_cfg_args(model_path: str, args: Namespace):
    """Persist flags to <model_path>/cfg_args (reference train.py:362-363)."""
    os.makedirs(model_path, exist_ok=True)
    with open(os.path.join(model_path, "cfg_args"), "w") as f:
        f.write(repr(args))


def get_combined_args(parser: ArgumentParser, argv=None) -> Namespace:
    """CLI over persisted cfg_args merge (reference :126-146)."""
    import sys

    argv = sys.argv[1:] if argv is None else argv
    args_cmdline = parser.parse_args(argv)
    cfg_string = "Namespace()"
    model_path = getattr(args_cmdline, "model_path", None)
    if model_path:
        path = os.path.join(model_path, "cfg_args")
        if os.path.exists(path):
            with open(path) as f:
                cfg_string = f.read()
    args_cfgfile = eval(cfg_string)  # noqa: S307 - same trust model as reference
    # Reference semantics (arguments/__init__.py:142-145): persisted cfg_args
    # values win; the command line only contributes keys the cfg lacks.
    merged = vars(args_cfgfile).copy()
    for k, v in vars(args_cmdline).items():
        if v is not None and k not in merged:
            merged[k] = v
    return Namespace(**merged)
