"""The port's `validate_e2e` scratch task end to end on the CPU (no JAX):
E2E_SMOKE=1, 20 iterations through `main`. Every step's loss is finite,
the scheduled events fire (a densify among them) and the artifact is well
formed. The task's own schedule densifies every 500 iterations inside the
normal-propagation window, so its first densify comes at iteration 500 of a
run of at least 1,002; here the densify intervals are cut to 2 so that one
fires within 20 iterations (iterations 6 and 8 of the window 5-10)."""
import json
import math

import pytest
import torch

from tpu_splat_torch.scripts import validate_e2e as tv


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the suite runs several test processes at once,
    and torch's spinning worker threads then take the cores from each
    other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_scratch_smoke(tmp_path, monkeypatch):
    monkeypatch.setenv("E2E_SMOKE", "1")
    schedule = tv.scratch_schedule

    def short_densify(opt, iterations):
        opt = schedule(opt, iterations)
        opt.densification_interval = opt.densification_interval_when_prop = 2
        return opt

    monkeypatch.setattr(tv, "scratch_schedule", short_densify)
    losses = []
    out = tmp_path / "scratch.json"
    verdict = tv.main(["--device", "cpu", "--iterations", "20", "--out", str(out),
                       "--save_state", str(tmp_path / "end.ply")],
                      on_step=lambda it, aux: it and losses.append(float(aux.loss)))
    assert len(losses) == 20 and all(math.isfinite(x) for x in losses)
    art = json.loads(out.read_text())
    assert art["verdict"] == verdict in ("PASS", "BELOW-BAR")
    assert art["task"] == "scratch" and art["backend"] == "cpu" and art["device"] == "cpu"
    assert art["workload"]["iterations"] == 20 and art["workload"]["H"] == 64
    assert art["events"]["densified"] > 0 and art["events"]["n_events"] > 0
    assert art["events"]["overflowed"] >= 0  # capacity 512: reported, not grown
    assert art["psnr_curve"][0][0] == 1 and math.isfinite(art["psnr_curve"][0][1])
    for k in ("train_view_psnr", "held_out_psnr", "held_out_ssim", "held_out_gmsd"):
        assert math.isfinite(art[k]), k
    assert len(art["held_out_per_view"]) == art["workload"]["held_out_views"] == 2
    assert art["bars"] == {"held_out": 30.0, "ssim_held_out": 0.90}
    assert (tmp_path / "end.ply").stat().st_size > 0 and (tmp_path / "end.map").exists()
