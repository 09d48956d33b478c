"""ray_tracing_tpu_torch: the PyTorch / CUDA port of ``ray_tracing_tpu``.

Loads the same reference-schema JSON scenes and renders them with the
same estimator and the same per-ray counter-hash randomness, on a CPU
tensor device or on an NVIDIA GPU, where the phase-A intersection of
spheres and rects, plain or transformed (ops/cuda_intersect.py), the
triangle sweep (ops/cuda_triangles.py) and the atlas-gradient
scatter-add (ops/cuda_scatter.py) run as hand-written CUDA kernels.  The
port covers the forward render of scenes of spheres, moving spheres,
rects, triangle meshes, instancing transforms and constant media, and
the full-parameter gradient pass of the same scenes, meshes, transforms
and media included, by one route (render/prb_scalar.py: ``params_of``
-> ``tiled_loss_and_grad``: per tile the taped compacted forward and its
sweep, then one fuzz / IR tangent pass), and its autograd face
``prb_radiance_all`` (``loss.backward()``).  ``parallel`` splits the
rays of a render pass or a train step over a ``torch.distributed``
process group; ``examples`` holds the three fit scripts.  ``python -m
ray_tracing_tpu_torch.cli`` renders a JSON scene progressively to an
image file (utils/: image, checkpoint and stats); ``scenes`` builds the
gallery's C3, C4 and C6 and the motion-blur example, and
``examples.render_baselines`` and ``examples.motion_blur`` render them.
A scene with a BVH and neither sweep nor cluster tables takes the BVH
walk (ops/bvh.py, plain PyTorch).  ``v4ray`` is the
reference's Python API over the port (``Scene``, an awaitable
``Renderer.render()``), ``v4ray_frontend`` the editor's plugins and
``editor`` the scene editor's core and its web server (``python -m
ray_tracing_tpu_torch.editor.web``).  See ROADMAP.md for what is still
to come.
"""

from ray_tracing_tpu_torch.models.camera import Camera, CameraParam
from ray_tracing_tpu_torch.models.compiler import (
    SceneBuilder,
    SceneBundle,
    build_scene,
    load_scene_json,
)
from ray_tracing_tpu_torch.models.scene import SceneData, scene_from_numpy
from ray_tracing_tpu_torch.ops.geometry import EPSILON  # reference src/lib.rs:34
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
    "EPSILON",
]
