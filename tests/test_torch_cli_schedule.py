"""Both packages' training CLI side by side on the CPU: the JAX package's
`tpu_splat.scripts.train.main` and the port's `main(..., device="cpu")`
train the 32x32 Blender scene of tests/test_scripts.py through the first
100 rect iterations of a 5100-iteration schedule, compressed so that every
scheduled event fires: the opacity-LR pulse every 20 iterations, densify
at 25, 50 and 75, normal propagation at 25 and 75, the opacity reset and
colour sabotage at 50, the env-map doubling at 90; the reflection stage
starts at 10, the ISP's scene freeze at 100 (a schedule's last 5000), and
the growth check runs at 100. Both runs stop before step 101.

As in tests/test_torch_loop.py, the port is handed the JAX draws (jax.random's
bits are not reproduced): the initial cubemap texture of the JAX run and, at
each event, the draws that the JAX key gives. The JAX side runs its Pallas
kernels in interpret mode (backend="pallas"), as its own tests do; its CPU
"auto" path rounds the blend otherwise.

Held exactly: every step's inputs (frame index, scene-freeze flag, camera,
image), the events' calls (iteration, freeze flag, camera extent and
mean), the event log at every iteration (the port's also records the
opacity-LR pulse), the iterations at which densify changed the counts, the
growth checks' iterations, overflow inputs and decisions, and the files
each run writes.
Held at the step tests' tolerances (tests/test_torch_train.py): every
step's loss through step 25, the last before the first densify, 1e-5
relative; after step 25, the Adam moments 1e-2 of each leaf's max (nu
2e-2) and the DensifyStats 1e-3 of each field's max. Densify's counts and
the later steps are not held: a Gaussian whose gradient sits at the
threshold can be selected in one run and not the other, and the runs
drift apart from there.
"""
import dataclasses
import hashlib
import os

import numpy as np
import jax
import pytest
import torch

import tpu_splat
import tpu_splat.raster.config as jrc
from tests.test_scripts import _make_scene
from tests.test_torch_loop import _jax_keyed_draws

STOP = 100  # the last step of both runs
HELD = 25  # the last step before the first densify event
SCHEDULE = ["--iterations", "5100", "--freeze_xyz_last_iters", "1", "--init_until_iter", "10",
            "--densify_from_iter", "10", "--densification_interval", "20",
            "--densification_interval_when_prop", "25", "--opacity_reset_interval", "50",
            "--opac_lr0_interval", "20", "--normal_prop_interval", "25",
            "--normal_prop_until_iter", "80", "--color_sabotage_interval", "50",
            "--color_sabotage_until_iter", "80", "--densify_until_iter", "90",
            "--test_iterations", "0", "--save_iterations", "50", "--checkpoint_iterations", "50"]
ARGS = ["--eval", "-q", "--disable_viewer", "--num_points", "300", "--cubemap_resol", "8",
        "--max_tiles_per_gaussian", "8", "--max_instances", "8192", "--tile_depth", "256",
        *SCHEDULE]
# iteration -> the events the schedule fires there (the JAX log's names)
EVENTS = {25: ["normal_prop"], 50: ["reset_opacity", "color_sabotage"], 75: ["normal_prop"],
          90: ["double_env_map"]}
DENSIFY = (25, 50, 75)
PULSES = [20, 40, 60, 80]


class _Stop(Exception):
    pass


def _host(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _record(mp, pkg, stop, held=None, jit=None):
    """Wrap `pkg`'s step, scheduled events and growth check, as the CLI
    calls them, to record what each is given and gives back; the step
    raises _Stop in place of step `stop` + 1."""
    import importlib

    step_mod = importlib.import_module(pkg + ".train.step")
    loop_mod = importlib.import_module(pkg + ".train.loop")
    grow_mod = importlib.import_module(pkg + ".train.grow")
    rec = dict(steps=[], events=[], growth=[])
    make, events, growth = (step_mod.make_train_step, loop_mod.run_scheduled_events,
                            grow_mod.check_growth)

    def make_recorded(*a, **k):
        step = make(*a, **k)
        step = jit(step) if jit is not None else step

        def recorded(ts, cam, gt, bg, gt_alpha=None, frozen=False, frame_idx=-1):
            it = int(ts.step) + 1
            if it > stop:
                raise _Stop()
            if it == 1:
                rec["texture"] = _host(ts.gaussians.env.texture)
            ts, aux = step(ts, cam, gt, bg, gt_alpha=gt_alpha, frozen=frozen,
                           frame_idx=frame_idx)
            rec["steps"].append(dict(
                iteration=it, frame_idx=int(frame_idx), frozen=bool(frozen),
                world_view=_host(cam.world_view), alpha=gt_alpha,
                gt=hashlib.sha1(np.ascontiguousarray(_host(gt)).tobytes()).hexdigest(),
                loss=float(aux.loss)))
            if it == held:
                rec["held"] = dict(mu={k: _host(v) for k, v in ts.opt.mu.items()},
                                   nu={k: _host(v) for k, v in ts.opt.nu.items()},
                                   stats=[_host(v) for v in ts.stats])
            return ts, aux

        recorded.recorded = True
        return recorded

    def events_recorded(ts, iteration, opt_cfg, **k):
        lg = k["log"]
        ts = events(ts, iteration, opt_cfg, **k)
        rec["events"].append(dict(
            iteration=iteration, scene_frozen=k["scene_frozen"],
            cameras_extent=k["cameras_extent"], cameras_mean=np.asarray(k["cameras_mean"]),
            log=[e for e in lg.events if e[1] != "opacity_lr_pulse"],
            pulses=[i for i, e in lg.events if e == "opacity_lr_pulse"],
            counts=(lg.densified, lg.pruned, lg.overflowed)))
        return ts

    def growth_recorded(ts, cfg, **k):
        dec = growth(ts, cfg, **k)
        rec["growth"].append(dict(
            iteration=rec["steps"][-1]["iteration"], grew=dec.grew, reasons=list(dec.reasons),
            **{n: k[n] for n in ("n_alive", "densify_overflow", "pad_overflow")}))
        return dec

    mp.setattr(step_mod, "make_train_step", make_recorded)
    mp.setattr(loop_mod, "run_scheduled_events", events_recorded)
    mp.setattr(grow_mod, "check_growth", growth_recorded)
    return rec, loop_mod


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def run_both(src, root, args, stop, held=None):
    """Train the scene `src` with both packages' CLI (flags `args`, model
    directories root/jax and root/port) for `stop` steps, the port on the
    CPU with the JAX run's draws. -> {"jax": record, "port": record}."""
    from tpu_splat.scripts import train as jcli

    from tpu_splat_torch.model import state as tstate
    from tpu_splat_torch.scripts import train as tcli

    out = {}
    with pytest.MonkeyPatch.context() as mp:
        real_jit, real_production = jax.jit, jrc.production_config
        out["jax"], _ = _record(mp, "tpu_splat", stop, held, jit=real_jit)
        # the CLI jits the step it builds: the recorder, which jits the
        # real step itself, goes through as it is
        mp.setattr(jax, "jit", lambda f, *a, **k: f if getattr(f, "recorded", False)
                   else real_jit(f, *a, **k))
        mp.setattr(jrc, "production_config", lambda **k: real_production(backend="pallas", **k))
        mp.setattr(tpu_splat, "setup_compilation_cache", lambda *a, **k: None)
        with pytest.raises(_Stop):
            jcli.main(["-s", src, "-m", os.path.join(root, "jax"), *args])
    with pytest.MonkeyPatch.context() as mp:
        out["port"], loop_mod = _record(mp, "tpu_splat_torch", stop, held)
        texture = torch.from_numpy(np.array(out["jax"]["texture"]))
        init = tstate.init_from_pcd

        def init_with_jax_texture(*a, **k):
            g = init(*a, **k)
            return dataclasses.replace(g, env=g.env._replace(texture=texture.clone()))

        mp.setattr(tstate, "init_from_pcd", init_with_jax_texture)
        key = {"key": jax.random.PRNGKey(0)}  # TrainState.create's key
        events = loop_mod.run_scheduled_events
        mp.setattr(loop_mod, "run_scheduled_events",
                   lambda ts, it, cfg, **k: events(ts, it, cfg, draws=_jax_keyed_draws(key), **k))
        with pytest.raises(_Stop):
            tcli.main(["-s", src, "-m", os.path.join(root, "port"), *args], device="cpu")
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("schedule")
    src = str(root / "scene")
    _make_scene(src)
    return dict(run_both(src, str(root), ARGS, STOP, HELD), root=root)


def test_steps_get_the_same_inputs(runs):
    j, t = runs["jax"]["steps"], runs["port"]["steps"]
    assert [s["iteration"] for s in t] == list(range(1, STOP + 1))
    assert [(s["frame_idx"], s["frozen"]) for s in t] == [(s["frame_idx"], s["frozen"]) for s in j]
    assert [s["iteration"] for s in t if s["frozen"]] == [STOP]
    for a, b in zip(j, t):
        np.testing.assert_array_equal(b["world_view"], a["world_view"], str(a["iteration"]))
        assert b["gt"] == a["gt"] and a["alpha"] is None and b["alpha"] is None, a["iteration"]


def test_events_and_growth_match_jax(runs):
    j, t = runs["jax"], runs["port"]
    drop = lambda r: {k: v for k, v in r.items() if k not in ("cameras_mean", "counts", "pulses")}
    assert [drop(r) for r in t["events"]] == [drop(r) for r in j["events"]]
    for a, b in zip(j["events"], t["events"]):
        np.testing.assert_array_equal(b["cameras_mean"], a["cameras_mean"])
    log = t["events"][-1]["log"]
    assert {i: [e for k, e in log if k == i] for i in EVENTS} == EVENTS, log
    assert t["events"][-1]["pulses"] == PULSES
    # densify ran where the schedule puts it, in both runs
    for rec in (j, t):
        counts = {r["iteration"]: r["counts"] for r in rec["events"]}
        changed = [i for i in range(2, STOP + 1) if counts[i] != counts[i - 1]]
        assert changed == list(DENSIFY), changed
    # the growth check: where it ran, what it decided, and the inputs that
    # do not hang on where densify's threshold fell
    held = lambda g: {k: v for k, v in g.items() if k != "n_alive"}
    assert [g["iteration"] for g in t["growth"]] == [STOP]
    assert [held(g) for g in t["growth"]] == [held(g) for g in j["growth"]]


def test_losses_and_state_match_jax_through_the_first_densify(runs):
    j, t = runs["jax"], runs["port"]
    for a, b in zip(j["steps"][:HELD], t["steps"][:HELD]):
        assert abs(b["loss"] - a["loss"]) <= 1e-5 * abs(a["loss"]), (a["iteration"], a["loss"],
                                                                     b["loss"])
    hj, ht = j["held"], t["held"]
    for m, tol in (("mu", 1e-2), ("nu", 2e-2)):
        assert sorted(ht[m]) == sorted(hj[m])
        for k, want in hj[m].items():
            err = np.abs(ht[m][k] - want).max() / max(np.abs(want).max(), 1e-30)
            assert err <= tol, (m, k, err)
    for name, got, want in zip(("grad_accum", "denom", "accum_w", "denom_w", "max_radii"),
                               ht["stats"], hj["stats"]):
        err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
        assert err <= 1e-3, (name, err)


def test_runs_write_the_same_files(runs):
    j, t = _files(runs["root"] / "jax"), _files(runs["root"] / "port")
    assert t == j
    assert "chkpnt50.npz" in t and "point_cloud/iteration_50/point_cloud.ply" in t
