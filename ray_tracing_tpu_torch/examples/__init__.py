"""Inverse-rendering examples of the port, the counterparts of the JAX
package's ``examples/fit_albedo.py``, ``fit_materials.py`` and
``fit_geometry.py``, with the same flags and defaults plus ``--device``
(default ``cuda``).  Run as ``python -m
ray_tracing_tpu_torch.examples.fit_materials --device cpu``.
``weekend_scene`` writes the editor's "One Weekend" project file, the
counterpart of ``examples/weekend_scene.py``."""

import torch


def device_of(name: str) -> torch.device:
    """The torch device ``--device`` names; exits with a message (code 1)
    when it is a GPU and none is available, never falling back."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {name}: no CUDA device is available "
                         "(torch.cuda.is_available() is False); pass --device cpu to "
                         "run on the CPU")
    return device
