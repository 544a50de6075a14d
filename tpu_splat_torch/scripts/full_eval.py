"""Eval-suite orchestration (port of tpu_splat/scripts/full_eval.py; role
of reference full_eval*.py).

Shells out to `python -m tpu_splat_torch.scripts.{train,render,eval_fps,
metrics,...}` per scene, each on the card. Flag bundles come
from scene_args.yaml — the same data/real/synthetic/args structure the
reference ships — plus suite presets reproducing each reference
full_eval*.py script:

  full       train -> render -> fps -> metrics over a dataset's scene set,
             dataset-type args from the yaml (reference full_eval.py)
  envgs      ref_real + envgs scenes at 55k iters with per-scene env-scope
             spheres from the yaml (reference full_eval_envgs.py:28-34)
  real       60k iters, renders at BOTH 60000 and 90000, then diff-map
             sheets (reference full_eval_real.py:48-89)
  specular   specular_100/75/50 at 30k iters (full_eval_specular.py:17,35)
  materials  the camera_regular env x density x material grid with per-scene
             logs, continuing past failures (full_eval_materials.py:11-30,
             :53-95)
  custom     custom/{mirror,glossy,rough,black,white,closer}
             (full_eval_custom.py:17)

Every stage honors --skip_training/--skip_rendering/--skip_metrics, writes
timing.json, and finishes with collect_results.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from argparse import ArgumentParser

SCENE_SETS = {
    # reference full_eval.py:18-22
    "ref_real": ["gardenspheres", "sedan", "toycar"],
    "envgs": ["angel", "bell", "cat", "horse", "luyu", "potion", "tbell", "teapot"],
    "shiny_blender": ["ball", "car", "coffee", "helmet", "teapot", "toaster"],
    "nerf_synthetic": ["chair", "drums", "ficus", "hotdog", "lego", "materials",
                        "mic", "ship"],
    "GlossySynthetic": ["angel", "bell", "cat", "horse", "luyu", "potion",
                         "tbell", "teapot"],
}

# reference full_eval_materials.py:11-30: env x density x material grid
# (constant env has no "diffuse" row)
_MAT_DENSITIES = ["dense_rand", "sparse_rand", "dense_regular", "sparse_regular"]
_MAT_FOREST = ["diffuse", "glossy", "metal", "mirror", "black", "white"]
_MAT_CONST = ["glossy", "metal", "mirror", "black", "white"]
MATERIALS_SCENES = [
    f"camera_regular/{env}/{dens}/{mat}"
    for env in ("forest_env_sphere", "forest_env_cube")
    for dens in _MAT_DENSITIES
    for mat in _MAT_FOREST
] + [
    f"camera_regular/{env}/{dens}/{mat}"
    for env in ("constant_env_sphere", "constant_env_cube")
    for dens in _MAT_DENSITIES
    for mat in _MAT_CONST
]

SPECULAR_SCENES = ["specular/specular_100", "specular/specular_75",
                   "specular/specular_50"]
CUSTOM_SCENES = ["custom/mirror", "custom/glossy", "custom/rough",
                 "custom/black", "custom/white", "custom/closer"]
REAL_SUITE_SCENES = ["ref_real/gardenspheres", "ref_real/sedan",
                     "ref_real/toycar", "envgs/dog", "envgs/audi"]


def load_scene_args(path: str | None):
    """Read the scene_args.yaml bundles (dataset-type train/render args +
    per-scene extras). Returns (cfg dict, lookup fns)."""
    import yaml

    if path is None:
        path = os.path.join(os.path.dirname(__file__), "..", "..",
                            "scene_args.yaml")
    cfg = {}
    if os.path.exists(path):
        with open(path) as f:
            cfg = yaml.safe_load(f) or {}

    real_sets = set(cfg.get("data", {}).get("realDatasets", []))

    def dataset_args(dataset: str, stage: str) -> list[str]:
        kind = "real" if dataset in real_sets else "synthetic"
        return (cfg.get(kind, {}).get(stage, "") or "").split()

    def scene_args(scene_key: str) -> list[str]:
        return (cfg.get("args", {}).get(scene_key, "") or "").split()

    return cfg, dataset_args, scene_args


def run(cmd: list[str], log_path: str | None = None) -> int:
    print("+", " ".join(cmd), flush=True)
    if log_path:
        with open(log_path, "a") as log:
            return subprocess.call(cmd, stdout=log, stderr=subprocess.STDOUT)
    return subprocess.call(cmd)


def _py(mod: str) -> list[str]:
    return [sys.executable, "-m", f"tpu_splat_torch.scripts.{mod}"]


def _stage_scenes(args):
    """Resolve (scene_keys, per-suite stage plan)."""
    if args.scenes:
        return list(args.scenes)
    if args.suite == "materials":
        return MATERIALS_SCENES
    if args.suite == "specular":
        return SPECULAR_SCENES
    if args.suite == "custom":
        return CUSTOM_SCENES
    if args.suite in ("envgs", "real"):
        return REAL_SUITE_SCENES
    if args.scene_set:
        return [f"{args.scene_set}/{s}" for s in SCENE_SETS[args.scene_set]]
    return []


# per-suite fixed train args (the reference scripts' common_args, translated
# to this CLI's spellings; --normal_propagation/--color_sabotage positive
# aliases are accepted by the config system)
SUITE_TRAIN_ARGS = {
    "full": [],
    "envgs": ["--quiet", "--iterations", "55000",
              "--normal_propagation", "--color_sabotage",
              "--densification_interval_when_prop", "500",
              "--init_until_iter", "3000", "--refl_init_value", "1e-1",
              "--longer_prop_iter", "15000", "--use_env_scope"],
    "real": ["--quiet", "--iterations", "60000",
             "--normal_propagation", "--color_sabotage",
             "--densification_interval_when_prop", "500",
             "--densification_interval", "500",
             "--init_until_iter", "3000", "--refl_init_value", "1e-4",
             "--longer_prop_iter", "15000", "--use_env_scope"],
    "specular": ["--disable_viewer", "--quiet",
                 "--save_iterations", "30000", "--iterations", "30000",
                 "--normal_propagation", "--color_sabotage",
                 "--init_until_iter", "20",
                 "--densification_interval_when_prop", "500", "-w"],
    "materials": ["--disable_viewer", "--quiet", "-w",
                  "--iterations", "35000", "--init_until_iter", "20"],
    "custom": ["--disable_viewer", "--quiet", "-w",
               "--iterations", "35000", "--init_until_iter", "20"],
}


def main(argv=None):
    parser = ArgumentParser()
    parser.add_argument("--base_dir", required=True, help="datasets root")
    parser.add_argument("--output_path", default="./eval")
    parser.add_argument("--scenes", nargs="+", default=None,
                        help="dataset/scene keys; overrides --scene_set/--suite lists")
    parser.add_argument("--scene_set", choices=sorted(SCENE_SETS), default=None)
    parser.add_argument("--suite", choices=sorted(SUITE_TRAIN_ARGS), default="full")
    parser.add_argument("--scene_args_yaml", default=None)
    parser.add_argument("--skip_training", action="store_true")
    parser.add_argument("--skip_rendering", action="store_true")
    parser.add_argument("--skip_metrics", action="store_true")
    parser.add_argument("--extra_train_args", nargs="*", default=[])
    args = parser.parse_args(argv)

    scenes = _stage_scenes(args)
    if not scenes:
        print("No scenes selected (pass --scenes, --scene_set or a --suite "
              "with a fixed grid)")
        return 1

    _, dataset_args, scene_args = load_scene_args(args.scene_args_yaml)
    os.makedirs(args.output_path, exist_ok=True)
    timing = {}

    for scene in scenes:
        dataset = scene.split("/")[0]
        src = os.path.join(args.base_dir, scene)
        out = os.path.join(args.output_path, scene)
        os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
        log = os.path.join(args.output_path,
                           scene.replace("/", "_") + ".log")

        train_args = list(SUITE_TRAIN_ARGS[args.suite])
        render_args = []
        if args.suite == "full":
            train_args += dataset_args(dataset, "train")
            render_args += dataset_args(dataset, "render")
        train_args += scene_args(scene)  # per-scene -r / env-scope bundles

        if not args.skip_training:
            t0 = time.time()
            rc = run(
                _py("train") + ["-s", src, "-m", out, "--eval"]
                + train_args + args.extra_train_args,
                log,
            )
            timing[scene] = (time.time() - t0) / 60
            with open(os.path.join(args.output_path, "timing.json"), "w") as f:
                json.dump(timing, f, indent=2)
            if rc:
                # reference materials runner continues past failed scenes
                # (full_eval_materials.py:167-168)
                print(f"[WARN] training failed for {scene} (rc={rc}); continuing")
                continue

        if not args.skip_rendering:
            if args.suite == "real":
                # reference full_eval_real.py:87-89: dual renders + diff maps
                run(_py("render") + ["-m", out, "--skip_train",
                                     "--iteration", "60000"], log)
                run(_py("render") + ["-m", out, "--skip_train",
                                     "--iteration", "90000"], log)
                run(_py("view_diff_maps") + ["-m", out], log)
            else:
                run(_py("render") + ["-m", out, "--skip_train"] + render_args,
                    log)
            run(_py("eval_fps") + ["-m", out], log)
        if not args.skip_metrics:
            run(_py("metrics") + ["-m", out], log)

    run(_py("collect_results")
        + ["--output_path", args.output_path, "--scenes"] + scenes)
    return 0


if __name__ == "__main__":
    sys.exit(main())
