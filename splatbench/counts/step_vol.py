"""Float32 operations of a whole training step on volumetric 3DGS-DR
Gaussians, for `step_mfu.train`: the blend's pairs (counts/) plus the
per-Gaussian EWA preprocess and the per-parameter and per-pixel terms of
`step.py`, each written down below from the equations the step evaluates
(forward; a backward costs about twice its forward)."""
from __future__ import annotations

from splatbench.counts import blend_backward, blend_forward
from splatbench.counts.step import (ADAM_OPS, ISP_OPS, LOSS_OPS, NORMAL_OPS, REFLECTION_OPS,
                                    SSIM_OPS)

# per Gaussian, forward, by term of the EWA preprocess
PREPROCESS_TERMS = dict(
    rotation=30,  # quaternion normalised, to a 3x3 rotation
    cov3d=9 + 45,  # R diag(s), then (R S)(R S)^T: 9 entries of 3 multiply-adds
    view=21,  # the centre's view transform
    jacobian=12,  # clamped tangents, focal over depth, the depth column
    t_matrix=30,  # J W: 6 entries of 3 multiply-adds
    cov2d=50,  # T Sigma (6 entries) then (T Sigma) T^T (4 entries), 5 ops an entry
    dilation_det=10,  # +0.3 on the diagonal, the determinant before and after
    centre=30,  # the projection of the centre, its divide and pixel mapping
    radius=12,  # eigenvalue bound, square root, 3 sigma, ceiling
    sqrtm=12,  # the 2x2 square root: root of the determinant, trace, root, divides
    homography=9,  # z [[A, mu], [0, 0, 1]]
    rect=12,  # the square tile rect and its area
    normal=25,  # argmin of three scales, the column, its sign, its view transform
    colour=146,  # view direction (10), degree-3 SH basis (~40), 16 x 3 multiply-adds (96)
    activations=10,  # opacity and reflection sigmoids
)
PREPROCESS_OPS = sum(PREPROCESS_TERMS.values())
PARAMS_PER_GAUSSIAN = 60  # xyz 3, SH 48, log-scale 3, quaternion 4, two logits


def train_step_ops(pairs: dict, n_tiles: int, n_gaussians: int, n_texels: int,
                   n_pixels: int) -> float:
    f_ops, _ = blend_forward(pairs, n_tiles, packed=True)
    b_ops, _ = blend_backward(pairs, n_tiles, packed=True)
    per_pixel = REFLECTION_OPS + ISP_OPS + LOSS_OPS + SSIM_OPS + NORMAL_OPS
    return (f_ops + b_ops + 3 * PREPROCESS_OPS * n_gaussians + 3 * per_pixel * n_pixels
            + ADAM_OPS * (PARAMS_PER_GAUSSIAN * n_gaussians + n_texels))
