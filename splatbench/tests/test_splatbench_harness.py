"""CPU tests of the benchmark harness at a tiny size: the cells run through
the port's CPU path (the kernels' plain versions) and the plain reference.

    python -m pytest splatbench/tests -q -p no:randomly
"""
from __future__ import annotations

import copy
import json
import os
import shutil
import subprocess
import sys
import time

import pytest
import torch

from splatbench import counts, run
from splatbench.reference import splat

ROOT = run.ROOT


def tiny_context(cell: str, seed: int = 5, trace: bool = False, root: str = ROOT, **kw):
    """The cell's files, shrunk to 64x96 and 3000 surfels, on the CPU."""
    bench, c, conf, mix, limits = run.load_cell(cell, root)
    conf, mix = copy.deepcopy(conf), copy.deepcopy(mix)
    conf["image"] = {"height": 64, "width": 96}
    conf["scene"].update(n_surfels=3000, capacity=4096)
    if "cubemap" in conf["scene"]:
        conf["scene"]["cubemap"] = 16
    conf["raster"].update(max_tiles_per_gaussian=16, tile_depth=256)
    if mix["driver"] == "train":
        mix.update(views=4, trace_steps=3)
    else:
        mix.update(orbit_frames=24, trace_frames=4, check_within=6, check_frames=2,
                   rate_hz=20.0 if mix["rate_hz"] > 0 else 0.0, count_stride=2)
    ctx = run.Context(cell=c, config=conf, traffic=mix, limits=limits, seed=seed,
                      seconds=kw.pop("seconds", 0.5), trace=trace, device=torch.device("cpu"),
                      t_start=time.perf_counter(), root=root, **kw)
    return bench, ctx


def tiny_line(cell: str, **kw) -> dict:
    bench, ctx = tiny_context(cell, **kw)
    return run.finish(run.execute(ctx, bench))[0]


def test_without_a_card_the_run_exits_nonzero_and_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, "-m", "splatbench.run", "--workload",
                        "train-synth1m-1080p", "--seed", "1", "--seconds", "1"],
                       cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert p.stdout.strip() == ""


@pytest.mark.parametrize("cell,trace", [("train-synth1m-1080p", False),
                                        ("serve-synth1m-1080p", True),
                                        ("serve-max-synth1m-1080p", False)])
def test_result_line_has_the_contract_keys_and_the_checks_last(cell, trace):
    line = tiny_line(cell, trace=trace)
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    if trace:
        keys.append("breakdown")
    assert list(line) == keys + ["checks"]
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    if trace:
        assert set(line["device"]) >= {"busy_s", "window_s"}
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}
    bench = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    units = {m["name"]: m["unit"] for m in bench["end_to_end"] + bench["per_layer"]}
    for name, m in line["metrics"].items():
        assert m["unit"] == units[name]
    if not trace:
        own = {w["name"]: w for w in bench["workloads"]}[cell]
        assert set(line["metrics"]) == run.end_to_end(bench, own)


def test_a_new_configuration_mix_metric_and_cell_are_files_and_entries_only(tmp_path):
    """A later PR adds a cell by adding files and entries: copy the
    benchmark, add a toy configuration, traffic mix and per-layer metric as
    new files and a cell for them in BENCHMARK.json, and run it."""
    root = str(tmp_path)
    shutil.copytree(os.path.join(ROOT, "splatbench"), os.path.join(root, "splatbench"),
                    ignore=shutil.ignore_patterns(".cache", "__pycache__", "data"))
    os.symlink(os.path.join(ROOT, "splatbench", "data"), os.path.join(root, "splatbench", "data"))
    bench = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    sb = os.path.join(root, "splatbench")
    conf = json.load(open(os.path.join(sb, "configs", "synth1m-1080p.json")))
    conf.update(name="toy", scene=dict(conf["scene"], scale_mu=-4.0))
    json.dump(conf, open(os.path.join(sb, "configs", "toy.json"), "w"))
    mix = json.load(open(os.path.join(sb, "traffic", "viewer-orbit.json")))
    mix.update(elevation=0.5)
    json.dump(mix, open(os.path.join(sb, "traffic", "toy-orbit.json"), "w"))
    with open(os.path.join(sb, "metrics", "toy_frames.serve.py"), "w") as f:
        f.write("def read(t):\n    return float(t.steps)\n")
    bench["configs"].append(dict(bench["configs"][0], name="toy", file="splatbench/configs/toy.json"))
    bench["workloads"].append(dict(name="serve-toy", config="toy", traffic="toy-orbit", chips=1,
                                   why="a toy"))
    for m in bench["end_to_end"]:
        if "serve-synth1m-1080p" in m.get("workloads", []):
            m["workloads"].append("serve-toy")
    bench["per_layer"].append(dict(name="toy_frames.serve", unit="count", better="higher",
                                   source="program_counter", layer="viewer",
                                   moves="serve_frame_ms_p95", workloads=["serve-toy"]))
    json.dump(bench, open(os.path.join(root, "BENCHMARK.json"), "w"))
    line = tiny_line("serve-toy", root=root, trace=True)
    assert line["metrics"]["toy_frames.serve"]["value"] == 4.0
    assert line["correct"]


def _modules_after(code: str) -> list:
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                       timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    return json.loads(p.stdout.strip().splitlines()[-1])


def test_a_rehearsed_cell_loads_neither_jax_nor_the_jax_package():
    mods = _modules_after(
        "import json, sys\n"
        "sys.path.insert(0, 'splatbench/tests')\n"
        "from test_splatbench_harness import tiny_line\n"
        "tiny_line('train-synth1m-1080p')\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    assert "tpu_splat_torch" in mods
    assert not {"jax", "jaxlib", "flax", "tpu_splat"} & set(mods)


def test_the_reference_loads_nothing_of_the_program():
    mods = _modules_after(
        "import json, sys, torch\n"
        "from splatbench import scene\n"
        "from splatbench.reference import splat, train\n"
        "dev = torch.device('cpu')\n"
        "sc = dict(kind='synthetic', n_surfels=500, sh_degree=3, scale_mu=-4.0, scale_sigma=0.5,"
        " refl_logit=-2.2, cubemap=8)\n"
        "p = scene.cloud(sc, 3, dev)\n"
        "cam = splat.camera(*scene.orbit(32, 48, 6.0, 0.4, 0.3, 0.8), 32, 48, dev)\n"
        "splat.frame(p, cam, torch.zeros(3), splat.Precision(), splat.Binning())\n"
        "p.update(train.isp_init(2, dev)); p['alive'] = torch.ones(500, dtype=torch.bool)\n"
        "opt = dict(lambda_dssim=0.2, lambda_normal=0.05, position_lr_init=1.6e-4,"
        " position_lr_final=1.6e-6, position_lr_max_steps=30000, feature_lr=2.5e-3,"
        " opacity_lr=0.05, scaling_lr=5e-3, rotation_lr=1e-3, refl_lr=6e-3,"
        " envmap_cubemap_lr=0.05, isp_lr=1e-3)\n"
        "train.run_steps(p, [(cam, torch.rand(32, 48, 3), 0)], torch.zeros(3), opt, 6.0, 100,"
        " splat.Precision(), splat.Binning())\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    assert not {"jax", "jaxlib", "flax", "tpu_splat", "tpu_splat_torch"} & set(mods)


def _toy_scene(device="cpu"):
    """Two overlapping opaque surfels facing the camera, one behind the
    other, in a 32x32 image."""
    p = dict(
        xyz=torch.tensor([[0.0, 0.0, 0.0], [0.05, 0.0, 0.5]]),
        features_dc=torch.zeros(2, 1, 3), features_rest=torch.zeros(2, 15, 3),
        scaling=torch.log(torch.tensor([[0.3, 0.2], [0.4, 0.4]])),
        rotation=torch.tensor([[1.0, 0.0, 0.0, 0.0], [1.0, 0.0, 0.0, 0.0]]),
        opacity=torch.tensor([[2.0], [3.0]]), refl=torch.tensor([[-2.0], [-2.0]]),
        env_texture=torch.zeros(6, 3, 4, 4), env_fail=torch.zeros(3))
    R = torch.eye(3).numpy()
    T = torch.tensor([0.0, 0.0, 4.0]).numpy()
    return p, splat.camera(R, T, 0.8, 0.8, 32, 32, device)


def test_the_counts_are_exact_and_repeat():
    p, cam = _toy_scene()
    runs = []
    for _ in range(2):
        _, info = splat.frame(p, cam, torch.zeros(3), splat.Precision(), splat.Binning(),
                              want_counts=True)
        runs.append(counts.blend_pairs(info["stats"]))
    assert runs[0] == runs[1]
    c = runs[0]
    # every instance is tested at least once per pixel of its tile until the
    # pixel terminates; two surfels never push T below 1e-4 (opacity <= 0.99)
    assert c["alpha_tests"] == 256 * c["instances"]
    assert 0 < c["contributing"] <= c["alpha_tests_bwd"] <= c["alpha_tests"]
    assert c["bwd_columns"] == c["instances"]
    ops, n_bytes = counts.blend_forward(c, 4, packed=False)
    assert ops == 40 * c["alpha_tests"] + 24 * c["contributing"]
    assert n_bytes == c["instances"] * 24 * 4 + 4 * 16 * 256 * 4 + 4 * 4 * 4


@pytest.mark.parametrize("cell", ["train-synth1m-1080p", "serve-synth1m-1080p",
                                  "train-synth1m-1080p-tight", "serve-scratch1m-1080p",
                                  "serve-max-synth1m-1080p"])
def test_the_reference_agrees_with_the_port_on_the_cpu(cell):
    line = tiny_line(cell)
    assert line["correct"], line["checks"]
    assert line["failed"] == 0 and line["attempted"] > 0
