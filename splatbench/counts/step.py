"""Float32 operations of a whole training step and of a served frame, for
`step_mfu.train` and `frame_mfu.serve`: the blend's pairs (counts/) plus
per-surfel, per-parameter and per-pixel terms, each written down below from
the equations the step evaluates (forward; a backward costs about twice its
forward)."""
from __future__ import annotations

from splatbench.counts import blend_backward, blend_forward

# per surfel, forward: quaternion to rotation (~30), homography 3x4 by 4x3
# (72), the screen box (~40), the view transform of centre and normal (30),
# degree-3 SH colour (basis ~40, 16 x 3 multiply-adds 96), opacity and
# reflection sigmoids (~10)
PREPROCESS_OPS = 318
# per parameter element: Adam's two moments, bias corrections, root,
# division and update
ADAM_OPS = 12
PARAMS_PER_SURFEL = 59  # xyz 3, SH 48, log-scale 2, quaternion 4, two logits
# per pixel, forward: camera ray (15) and its reflection about the normalised
# normal (25), cube face and coordinates (~15), 4-tap bilinear sample of 3
# channels (24), sigmoid (12), blend with the base colour (9)
REFLECTION_OPS = 100
ISP_OPS = 40  # vignette, 3x3 colour matrix, bias, tone curve
LOSS_OPS = 10  # L1
SSIM_OPS = 5 * 121 * 2 * 3 + 60  # five 11x11 depthwise convolutions of 3 channels, the map
NORMAL_OPS = 80  # depth-derived normal (cross product, normalise) and the dot product
ENCODE_OPS = 9  # clamp, scale, round of 3 channels


def train_step_ops(pairs: dict, n_tiles: int, n_surfels: int, n_texels: int,
                   n_pixels: int) -> float:
    f_ops, _ = blend_forward(pairs, n_tiles, packed=True)
    b_ops, _ = blend_backward(pairs, n_tiles, packed=True)
    per_pixel = REFLECTION_OPS + ISP_OPS + LOSS_OPS + SSIM_OPS + NORMAL_OPS
    return (f_ops + b_ops + 3 * PREPROCESS_OPS * n_surfels + 3 * per_pixel * n_pixels
            + ADAM_OPS * (PARAMS_PER_SURFEL * n_surfels + n_texels))


def frame_ops(pairs: dict, n_tiles: int, n_surfels: int, n_pixels: int) -> float:
    f_ops, _ = blend_forward(pairs, n_tiles, packed=False)
    return f_ops + PREPROCESS_OPS * n_surfels + (REFLECTION_OPS + ENCODE_OPS) * n_pixels
