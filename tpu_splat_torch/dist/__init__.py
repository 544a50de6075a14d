from tpu_splat_torch.dist.mesh import (
    Mesh,
    device_count,
    host_camera_indices,
    host_epoch_permutation,
    launch,
    make_mesh,
    multihost_init,
)
