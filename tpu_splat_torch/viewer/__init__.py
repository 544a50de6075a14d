"""The SIBR remote-viewer server (port of tpu_splat/viewer/)."""
from tpu_splat_torch.viewer.network_gui import (
    NetworkGUI,
    RENDER_MODES,
    encode_u8,
    render_net_image,
    serve,
    service_viewer,
    viewer_camera,
)
