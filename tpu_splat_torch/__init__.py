"""tpu_splat_torch — the PyTorch/CUDA port of `tpu_splat` for NVIDIA Hopper.

The package mirrors `tpu_splat/`'s layout and module names so each port
module sits where its JAX counterpart does. It imports `torch` and numpy
only; `tpu_splat/` stays the unchanged reference the port is tested against.

Ported so far: the serving path (`renderer.render_fast`) and the
single-device training step (`train.step.make_train_step` with
`TrainState.create`, production switches, the learned ISP), surfel mode,
down to four hand-written CUDA kernels under `csrc/`: the tile-blend
forward and backward, the segment sum of the gradient regroup and the
cubemap texel-gradient accumulation. Entry points default to
`device="cuda"` and raise when CUDA is absent unless the caller passes
`device="cpu"`.
"""

__version__ = "0.1.0"
