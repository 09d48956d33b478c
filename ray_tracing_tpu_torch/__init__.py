"""ray_tracing_tpu_torch: the PyTorch / CUDA port of ``ray_tracing_tpu``.

Loads the same reference-schema JSON scenes and renders them with the
same estimator and the same per-ray counter-hash randomness, on a CPU
tensor device or on an NVIDIA GPU, where the phase-A intersection
(ops/cuda_intersect.py) and the atlas-gradient scatter-add
(ops/cuda_scatter.py) run as hand-written CUDA kernels.  The port covers
the forward render of sphere and axis-aligned-rect scenes and their
full-parameter gradient pass (render/prb_scalar.py:
``params_of`` -> ``prb_loss_and_grad_all`` -> ``scalar_tangent_pass``);
see ROADMAP.md for what is still to come.
"""

from ray_tracing_tpu_torch.models.camera import Camera, CameraParam
from ray_tracing_tpu_torch.models.compiler import (
    SceneBuilder,
    SceneBundle,
    build_scene,
    load_scene_json,
)
from ray_tracing_tpu_torch.models.scene import SceneData, scene_from_numpy
from ray_tracing_tpu_torch.render.renderer import (
    Renderer,
    RendererParam,
    RenderResult,
    render_pass,
)

__all__ = [
    "Camera",
    "CameraParam",
    "SceneBuilder",
    "SceneBundle",
    "SceneData",
    "Renderer",
    "RendererParam",
    "RenderResult",
    "render_pass",
    "build_scene",
    "load_scene_json",
    "scene_from_numpy",
]
