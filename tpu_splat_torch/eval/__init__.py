"""Evaluation helpers (port of tpu_splat/eval/): image maps, LPIPS with its
weight-free GMSD fallback, and camera trajectories."""
