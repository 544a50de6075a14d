"""The reference's `.map` cubemap sidecar: a `torch.save`d state dict
(port of tpu_splat/model/torch_pickle.py, whose hand-written pickle exists
so that the JAX package need not import torch; the port has torch and uses
`torch.save` / `torch.load` with `weights_only=True`).

What `torch.save` writes here (a zip of `data.pkl`, whose tensors rebuild
through `torch._utils._rebuild_tensor_v2` from typed storages such as
`torch.FloatStorage`, plus one `data/<key>` record a storage) is what the
JAX package's `load_torch_state_dict` reads, and `torch.load` reads that
package's `save_torch_state_dict` output; tests/test_torch_io.py holds both
directions.
"""
from __future__ import annotations

import numpy as np
import torch


def save_torch_state_dict(path: str, state: dict):
    """Write {name: array or tensor} with `torch.save`, as CPU tensors."""
    torch.save(
        {k: torch.as_tensor(np.ascontiguousarray(np.asarray(
            v.detach().cpu() if isinstance(v, torch.Tensor) else v))).clone()
         for k, v in state.items()},
        path,
    )


def load_torch_state_dict(path: str) -> dict:
    """Read a torch-saved state dict into {name: numpy array}."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return {k: v.numpy() for k, v in sd.items()}
