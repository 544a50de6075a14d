"""CPU tests of the volumetric training cell (`train-vol-synth1m-1080p`,
driver `train_vol`) at the harness's tiny size: the port's plain CPU path
against the plain volumetric reference, each planted fault caught, and the
result line's names as BENCHMARK.json declares them.

    python -m pytest splatbench/tests -q -p no:randomly
"""
from __future__ import annotations

import importlib
import json
import os

import pytest
import torch

from splatbench import run
from splatbench.tests import test_splatbench_harness as harness

CELL = "train-vol-synth1m-1080p"


def vol_context(monkeypatch, **kw):
    """`tiny_context` for the cell: it shrinks a training mix when the mix's
    driver is named `train`, so the mix is shrunk under that name and handed
    back to `train_vol`."""
    real = run.load_cell

    def as_train(name, root=run.ROOT):
        bench, cell, conf, mix, limits = real(name, root)
        return bench, cell, conf, dict(mix, driver="train"), limits

    with monkeypatch.context() as m:
        m.setattr(run, "load_cell", as_train)
        bench, ctx = harness.tiny_context(CELL, **kw)
    ctx.traffic["driver"] = "train_vol"
    return bench, ctx


def vol_line(monkeypatch, **kw) -> dict:
    bench, ctx = vol_context(monkeypatch, **kw)
    return run.finish(run.execute(ctx, bench))[0]


def _bench():
    with open(os.path.join(run.ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("trace", [False, True])
def test_the_cell_agrees_with_the_reference_and_names_its_metrics(monkeypatch, trace):
    line = vol_line(monkeypatch, trace=trace)
    assert line["correct"], line["checks"]
    assert line["failed"] == 0 and line["attempted"] > 0
    assert set(line["checks"]) == {"loss", "grad_norm_median", "change_norm"}
    bench = _bench()
    cell = {w["name"]: w for w in bench["workloads"]}[CELL]
    units = {m["name"]: m["unit"] for m in bench["end_to_end"] + bench["per_layer"]}
    for name, m in line["metrics"].items():
        assert m["unit"] == units[name]
    if trace:
        listed = {m["name"] for m in bench["per_layer"] if CELL in m.get("workloads", [])}
        # the CPU run has no device trace: no idle share, no sync count
        assert set(line["metrics"]) == listed - {"device_idle_share.train",
                                                 "host_syncs_per_step.train"}
        assert line["metrics"]["normal_axis_ms.train"]["value"] > 0.0
    else:
        assert set(line["metrics"]) == run.end_to_end(bench, cell) == {
            "train_px_per_s", "train_peak_gib", "setup_s"}


def test_normals_from_the_longest_axis_are_caught(monkeypatch):
    render_mod = importlib.import_module("tpu_splat_torch.renderer.render")
    shortest = render_mod.shortest_axis_normals
    monkeypatch.setattr(render_mod, "shortest_axis_normals",
                        lambda xyz, scales, rot, cc: shortest(xyz, -scales, rot, cc))
    line = vol_line(monkeypatch)
    assert not line["correct"]


def test_a_loss_over_half_the_rows_is_caught(monkeypatch):
    import tpu_splat_torch.train.step as step_mod

    l1, ssim = step_mod.l1_loss, step_mod.ssim
    half = lambda x: x[: x.shape[0] // 2]
    monkeypatch.setattr(step_mod, "l1_loss", lambda a, b: l1(half(a), half(b)))
    monkeypatch.setattr(step_mod, "ssim", lambda a, b, **k: ssim(half(a), half(b), **k))
    line = vol_line(monkeypatch)
    assert not line["correct"]


def test_the_reference_on_tf32_operands_reads_above_the_limits(monkeypatch):
    from splatbench.tools import control_vol

    _, ctx = vol_context(monkeypatch)
    got = control_vol.train_readings(ctx.config, ctx.traffic, ctx.limits, 5,
                                     torch.device("cpu"))
    for control in ("tf32", "half_batch"):
        assert any(v > ctx.limits[name] for name, (v, _) in got[control].items()), got
    # the change over the steps is one of the numbers TF32 fails
    assert got["tf32"]["change_norm"][0] > ctx.limits["change_norm"], got


def test_a_program_without_the_volumetric_family_is_refused_in_set_up(monkeypatch):
    """The parent's program: its renderer has no shortest-axis normal, so a
    three-axis state would run the surfel preprocess. The driver stops
    before it draws the cloud."""
    render_mod = importlib.import_module("tpu_splat_torch.renderer.render")
    monkeypatch.delattr(render_mod, "shortest_axis_normals")
    import splatbench.scene as scene_mod

    def never(*a, **k):
        raise AssertionError("the cloud was drawn")

    monkeypatch.setattr(scene_mod, "cloud", never)
    with pytest.raises(SystemExit, match="no volumetric family"):
        vol_line(monkeypatch)


def test_a_configuration_asking_for_antialiasing_is_refused(monkeypatch):
    """The volumetric family renders without antialiasing, so the driver
    stops before it draws the cloud rather than run what the file does not
    say."""
    import splatbench.scene as scene_mod

    bench, ctx = vol_context(monkeypatch)
    ctx.config["antialiasing"] = True

    def never(*a, **k):
        raise AssertionError("the cloud was drawn")

    monkeypatch.setattr(scene_mod, "cloud", never)
    with pytest.raises(SystemExit, match="antialiasing"):
        run.execute(ctx, bench)


def test_the_volumetric_reference_loads_nothing_of_the_program():
    mods = harness._modules_after(
        "import json, sys\n"
        "from splatbench.reference import volumetric\n"
        "from splatbench.counts import step_vol\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    assert not {"jax", "jaxlib", "flax", "tpu_splat", "tpu_splat_torch"} & set(mods)
