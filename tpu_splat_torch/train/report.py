"""Train-time validation and TensorBoard logging (port of
tpu_splat/train/report.py; role of the reference train.py:353-487
prepare_output_and_logger / training_report).

At each test iteration: render the full test set and a sampled train subset
with the current model (`render_fast`), log L1/PSNR per set (stdout, JSONL
and TensorBoard when `torch.utils.tensorboard` imports), plus loss
components, total points and histogram summaries, under the reference's
scalar names (train.py:389-481).
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch


class TrainReporter:
    def __init__(self, model_path: str, enable_tb: bool = True):
        self.model_path = model_path
        self.jsonl = os.path.join(model_path, "training_report.jsonl")
        self.tb = None
        if enable_tb:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self.tb = SummaryWriter(model_path)
            except ImportError:
                print("Tensorboard not available: not logging progress")

    def scalars(self, iteration: int, values: dict):
        if self.tb is not None:
            for k, v in values.items():
                self.tb.add_scalar(k, float(v), iteration)

    def histogram(self, iteration: int, name: str, values: np.ndarray):
        if self.tb is not None:
            self.tb.add_histogram(name, values, iteration)

    def image(self, iteration: int, name: str, img_hwc: np.ndarray):
        if self.tb is not None:
            self.tb.add_image(name, np.clip(img_hwc, 0, 1).transpose(2, 0, 1), iteration)

    def evaluate(
        self,
        iteration: int,
        state,
        cfg,
        bg,
        test_cams,
        train_cams,
        n_train_sample: int = 5,
        log_images: bool = False,
    ) -> dict:
        """Render validation sets, log metrics (train.py:421-465)."""
        from tpu_splat_torch.renderer import render_fast
        from tpu_splat_torch.train.losses import l1_loss, psnr

        results = {}
        train_sample = [
            train_cams[idx % max(len(train_cams), 1)]
            for idx in range(5, 30, 5)[:n_train_sample]
        ] if train_cams else []
        bg_t = torch.as_tensor(bg, dtype=torch.float32, device=state.device)
        for name, cams in (("test", test_cams), ("train", train_sample)):
            if not cams:
                continue
            l1s, psnrs = [], []
            for vi, lc in enumerate(cams):
                out = render_fast(state, lc.camera, cfg, bg_t)
                img = torch.clamp(out.render, 0.0, 1.0)
                gt = torch.clamp(lc.image, 0.0, 1.0)
                l1s.append(float(l1_loss(img, gt)))
                psnrs.append(float(psnr(img, gt)))
                if log_images and self.tb is not None and vi < 5:
                    self.image(iteration, f"{name}_view_{vi}/render", img.cpu().numpy())
            results[name] = {"l1": float(np.mean(l1s)), "psnr": float(np.mean(psnrs))}
            self.scalars(
                iteration,
                {
                    f"{name}/loss_viewpoint - l1_loss": results[name]["l1"],
                    f"{name}/loss_viewpoint - psnr": results[name]["psnr"],
                },
            )
            print(
                f"[ITER {iteration}] Evaluating {name}: "
                f"L1 {results[name]['l1']:.4f} PSNR {results[name]['psnr']:.2f}"
            )
        with open(self.jsonl, "a") as f:
            f.write(json.dumps({"iteration": iteration, **results}) + "\n")
        return results

    def model_stats(self, iteration: int, state):
        """Opacity/refl histograms + total points (train.py:470-478)."""
        if self.tb is None:
            return
        from tpu_splat_torch.core import f32

        alive = state.alive
        opacity = f32.sigmoid(state.opacity[alive, 0]).cpu().numpy()
        refl = f32.sigmoid(state.refl[alive, 0]).cpu().numpy()
        self.histogram(iteration, "scene/opacity_histogram", opacity)
        self.histogram(iteration, "scene/refl_histogram", refl)
        self.scalars(iteration, {"total_points": int(alive.sum())})

    def close(self):
        if self.tb is not None:
            self.tb.close()
