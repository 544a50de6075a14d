"""A run whose timed path is broken underneath comes out `correct` false:
each fault a cell can have, planted in the port's CPU path at a tiny size
(the harness's look for a card is skipped; the rest of the run is whole).
The control, the plain reference in TF32, reads above the limits too."""
from __future__ import annotations

import dataclasses

import pytest
import torch

from splatbench.tests.test_splatbench_harness import tiny_line


def test_a_step_that_returns_its_state_unchanged_is_caught(monkeypatch):
    import tpu_splat_torch.train.step as step_mod

    real = step_mod.make_train_step

    def make(*a, **k):
        step = real(*a, **k)

        def frozen(ts, *args, **kw):
            new, aux = step(ts, *args, **kw)
            return dataclasses.replace(ts, step=new.step), aux

        return frozen

    monkeypatch.setattr(step_mod, "make_train_step", make)
    line = tiny_line("train-synth1m-1080p")
    assert not line["correct"]
    assert line["checks"]["change_norm"]["value"] == pytest.approx(1.0)


def test_a_loss_over_half_the_batch_is_caught(monkeypatch):
    import tpu_splat_torch.train.step as step_mod

    l1, ssim = step_mod.l1_loss, step_mod.ssim
    half = lambda x: x[: x.shape[0] // 2]
    monkeypatch.setattr(step_mod, "l1_loss", lambda a, b: l1(half(a), half(b)))
    monkeypatch.setattr(step_mod, "ssim", lambda a, b, **k: ssim(half(a), half(b), **k))
    line = tiny_line("train-synth1m-1080p")
    assert not line["correct"]


def test_an_update_altered_where_it_is_made_is_caught(monkeypatch):
    import tpu_splat_torch.train.step as step_mod

    adam = step_mod.adam_step

    def altered(params, grads, state, lrs):
        new, st = adam(params, grads, state, lrs)
        new = dict(new, opacity=params["opacity"] + 1.1 * (new["opacity"] - params["opacity"]))
        return new, st

    monkeypatch.setattr(step_mod, "adam_step", altered)
    line = tiny_line("train-synth1m-1080p")
    assert not line["correct"]


@pytest.mark.parametrize("cell", ["serve-synth1m-1080p", "serve-max-synth1m-1080p"])
def test_a_frame_altered_where_it_is_produced_is_caught(monkeypatch, cell):
    import tpu_splat_torch.viewer.network_gui as gui

    real = gui.render_net_image

    def altered(out, mode):
        img = real(out, mode).clone()
        img[16:32, 16:32] = 1.0 - img[16:32, 16:32]  # one 16x16 tile
        return img

    monkeypatch.setattr(gui, "render_net_image", altered)
    line = tiny_line(cell)
    assert not line["correct"]


@pytest.mark.parametrize("cell", ["train-synth1m-1080p", "serve-synth1m-1080p",
                                  "train-synth1m-1080p-tight", "serve-max-synth1m-1080p"])
def test_the_control_in_tf32_reads_above_the_limits(cell):
    """The reference put in the program's place, its matrix products and
    convolutions on TF32 operands, against the reference as stated."""
    from splatbench.tests.test_splatbench_harness import tiny_context
    from splatbench.tools import control

    _, ctx = tiny_context(cell)
    fn = control.train_readings if ctx.traffic["driver"] == "train" else control.serve_readings
    got = fn(ctx.config, ctx.traffic, ctx.limits, 5, torch.device("cpu"))["tf32"]
    assert any(v > ctx.limits[name] for name, (v, _) in got.items()), got
