"""Programmatic scenes of the JAX package's examples, built with the
port's own compiler:

* :func:`earth_sphere` -- configuration C3 of
  ``examples/render_baselines.py:scene_c3``: the earth-textured sphere
  (``data/earthmap.npy``, read without Pillow) on a ground rect under an
  important rect light and a sky, rendered at 512^2 (K1);
* :func:`bunny` -- configuration C4 of
  ``examples/render_baselines.py:scene_c4``: ``data/bunny.obj`` (4,968
  triangles, so the dense sweep K5) on a ground rect under a sky,
  rendered at 512^2;
* :func:`bunny_grid` -- configuration C6 of
  ``examples/render_baselines.py:scene_c6``: a 4x4 grid of
  ``data/bunny.obj`` (79,488 triangles, the only scene above
  ``SWEEP_MAX_TRIS``, so it takes the cluster sweep K6) on a ground
  rect under a sky, rendered at 512^2;
* :func:`motion_blur` -- ``examples/motion_blur.py:build_scene``: a
  checker floor, one static and two moving spheres under a sky, with
  the camera's shutter [0, 1], rendered at 384^2 depth 8 (the moving
  spheres take K4).

Each returns ``(SceneData, CameraParam, RendererParam)`` at the
example's own settings.  :func:`bunny_copies` builds the offset-bunny
meshes of ``tests/test_pallas_triangles.py:_grid_scene``, which the
cluster sweep is checked on (27 copies pass 1,024 clusters of 128).
"""

from __future__ import annotations

import os

import numpy as np

from ray_tracing_tpu_torch.models.camera import CameraParam
from ray_tracing_tpu_torch.models.compiler import SceneBuilder, load_image
from ray_tracing_tpu_torch.models.mesh import load_triangles
from ray_tracing_tpu_torch.render.renderer import RendererParam

DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "data")


def earth_sphere():
    """C3: a unit sphere with the earth image texture resting on a ground
    rect, lit by an important 3x3 rect light at y = 4; 512^2 at the
    renderer's default depth."""
    b = SceneBuilder(background=(0.7, 0.8, 1.0))
    earth = b.add_lambertian(b.add_texture_image(load_image(os.path.join(DATA, "earthmap.jpg"))))
    ground = b.add_lambertian(b.add_texture_solid((0.6, 0.6, 0.6)))
    light = b.add_diffuse_light(b.add_texture_solid((6.0, 6.0, 6.0)))
    b.add_sphere((0, 1.0, 0), 1.0, earth)
    b.add_rect("zx", -50, 50, -50, 50, 0.0, ground, positive=True)
    b.add_rect("zx", -1.5, 1.5, -1.5, 1.5, 4.0, light, positive=False, important=True)
    cam = CameraParam((0, 1.2, 4.0), (0, 1.0, 0), 40)
    return b.build(), cam, RendererParam(512, 512)


def bunny():
    """C4: one white lambertian bunny on a ground rect at y = 0.033, sky
    background; 512^2 at the renderer's default depth."""
    b = SceneBuilder(background=(0.7, 0.8, 1.0))
    white = b.add_lambertian(b.add_texture_solid((0.73, 0.73, 0.73)))
    ground = b.add_lambertian(b.add_texture_solid((0.4, 0.5, 0.4)))
    pts, nrm, uvs = load_triangles(os.path.join(DATA, "bunny.obj"))
    b.add_mesh_triangles(pts, nrm, uvs, white)
    b.add_rect("zx", -5, 5, -5, 5, 0.033, ground, positive=True)
    cam = CameraParam((-0.2, 0.25, 0.35), (-0.02, 0.1, 0.0), 35)
    return b.build(), cam, RendererParam(512, 512)


def bunny_grid():
    """C6: sixteen bunnies 0.25 apart on a 4x4 grid, one white lambertian
    mesh, a ground rect at y = 0.033, sky background; 512^2 at the
    renderer's default depth."""
    b = SceneBuilder(background=(0.7, 0.8, 1.0))
    white = b.add_lambertian(b.add_texture_solid((0.73, 0.73, 0.73)))
    ground = b.add_lambertian(b.add_texture_solid((0.4, 0.5, 0.4)))
    pts, nrm, uvs = load_triangles(os.path.join(DATA, "bunny.obj"))
    allp, alln, alluv = [], [], []
    for i in range(4):
        for j in range(4):
            off = np.asarray([(i - 1.5) * 0.25, 0.0, (j - 1.5) * 0.25], np.float32)
            allp.append(pts + off)
            alln.append(nrm)
            alluv.append(uvs)
    b.add_mesh_triangles(np.concatenate(allp), np.concatenate(alln), np.concatenate(alluv),
                         white)
    b.add_rect("zx", -5, 5, -5, 5, 0.033, ground, positive=True)
    cam = CameraParam((-0.7, 0.8, 1.2), (0.0, 0.1, 0.0), 40)
    return b.build(), cam, RendererParam(512, 512)


def bunny_copies(copies: int):
    """``copies`` offset bunnies in one mesh, no camera: four around the
    origin, or more on a 6-wide grid 0.3 apart."""
    b = SceneBuilder(background=(0.2, 0.2, 0.2))
    white = b.add_lambertian(b.add_texture_solid((0.7, 0.7, 0.7)))
    pts, nrm, uvs = load_triangles(os.path.join(DATA, "bunny.obj"))
    if copies <= 4:
        offs = [(-0.15, 0.0), (0.15, 0.0), (0.0, -0.15), (0.0, 0.15)][:copies]
    else:
        offs = [(0.3 * (i % 6) - 0.75, 0.3 * (i // 6) - 0.75) for i in range(copies)]
    allp = [pts + np.asarray([dx, 0.0, dz], np.float32) for dx, dz in offs]
    b.add_mesh_triangles(np.concatenate(allp), np.concatenate([nrm] * copies),
                         np.concatenate([uvs] * copies), white)
    return b.build()


def motion_blur():
    """Three spheres over a checker floor under a sky: static red, slow
    green, fast blue; shutter [0, 1]; 384^2 depth 8."""
    b = SceneBuilder(background=(0.70, 0.80, 1.00))
    checker = b.add_lambertian(b.add_texture_checker(
        b.add_texture_solid((0.2, 0.3, 0.1)), b.add_texture_solid((0.9, 0.9, 0.9)), 10.0))
    red = b.add_lambertian(b.add_texture_solid((0.85, 0.15, 0.1)))
    green = b.add_lambertian(b.add_texture_solid((0.15, 0.75, 0.2)))
    blue = b.add_lambertian(b.add_texture_solid((0.15, 0.25, 0.85)))
    b.add_rect("zx", -10, 10, -10, 10, 0.0, checker, positive=True)
    b.add_sphere((-1.2, 0.45, 0.0), 0.45, red)
    b.add_sphere_moving((-0.2, 0.45, 0.0), (0.3, 0.45, 0.0), 0.45, green)
    b.add_sphere_moving((0.9, 0.45, 0.0), (2.1, 0.45, 0.0), 0.45, blue)
    cam = CameraParam((0.3, 1.5, 4.5), (0.3, 0.45, 0.0), 35, time0=0.0, time1=1.0)
    return b.build(), cam, RendererParam(384, 384, max_depth=8)
