from tpu_splat_torch.renderer.render import (
    render,
    render_fast,
    render_env_map,
    get_refl_color,
    depth_to_normal,
    RenderOutput,
)
