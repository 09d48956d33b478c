"""The port's v4ray façade (ray_tracing_tpu_torch/v4ray/) and its editor
plugin framework (ray_tracing_tpu_torch/v4ray_frontend/): every case of
tests/test_v4ray_api.py on the port, rendering with device="cpu", and
the façade held against the JAX package's (v4ray_tpu) on the same
inputs: the compiled tables, the render keys and Sphere.hit."""

import asyncio
import math
from uuid import uuid4

import numpy as np
import pytest
import torch

import ray_tracing_tpu_torch.v4ray as v4ray
from ray_tracing_tpu_torch.ops import rng

from test_torch_scene import _assert_tables_equal

torch.set_num_threads(2)


def test_scene_build_and_async_render():
    scene = v4ray.Scene(background=(0.6, 0.7, 0.9))
    scene.add(
        v4ray.shape.Sphere((0, 0, -3), 1.0),
        v4ray.material.Lambertian(v4ray.texture.SolidColor((0.8, 0.3, 0.3))),
    )
    scene.add(
        v4ray.shape.Sphere((0, -101, -3), 100.0),
        v4ray.material.Metal((0.9, 0.9, 0.9), 0.1),
    )
    renderer = v4ray.Renderer(
        v4ray.RendererParam(32, 24, 4, True),
        v4ray.PerspectiveCameraParam((0, 0, 1), (0, 0, -1), 60),
        scene, device="cpu",
    )
    img = asyncio.run(renderer.render())
    assert isinstance(img, np.ndarray)
    assert img.shape == (24, 32, 3) and img.dtype == np.float32
    assert np.isfinite(img).all()
    img2 = asyncio.run(renderer.render())
    assert not np.array_equal(img, img2)  # fresh pass each call


def test_render_draws_fold_in_keys_of_the_jax_facade():
    """Call i renders rng.fold_in(rng.key(0), i), whose words equal the
    JAX façade's jax.random.fold_in(jax.random.key(0), i)."""
    import jax

    scene = v4ray.Scene(background=(0.6, 0.7, 0.9))
    scene.add(v4ray.shape.Sphere((0, 0, -3), 1.0),
              v4ray.material.Lambertian(v4ray.texture.SolidColor((0.8, 0.3, 0.3))))
    renderer = v4ray.Renderer(v4ray.RendererParam(16, 12, 3, True),
                              v4ray.PerspectiveCameraParam((0, 0, 1), (0, 0, -1), 60),
                              scene, device="cpu")
    for i in (1, 2):
        img = asyncio.run(renderer.render())
        key = rng.fold_in(rng.key(0), i)
        np.testing.assert_array_equal(
            key, np.asarray(jax.random.key_data(jax.random.fold_in(jax.random.key(0), i))))
        assert np.array_equal(img, renderer._inner.render(key).numpy())


def test_renderer_runs_on_the_card_unless_asked_for_the_cpu(monkeypatch):
    """The default device is cuda; without a GPU the façade raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    scene = v4ray.Scene(background=(0, 0, 0))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        v4ray.Renderer(v4ray.RendererParam(8, 8, 1),
                       v4ray.PerspectiveCameraParam((0, 0, 1), (0, 0, -1), 60), scene)
    assert v4ray.resolve_device("cpu") == torch.device("cpu")


def test_shared_material_compiles_once():
    scene = v4ray.Scene(background=(0, 0, 0))
    mat = v4ray.material.Dielectric(1.5)
    scene.add(v4ray.shape.Sphere((0, 0, -3), 1.0), mat)
    scene.add(v4ray.shape.Sphere((2, 0, -3), 1.0), mat)
    data = scene.compile()
    assert len(data.materials) == 1
    assert data.n_spheres == 2


def test_python_sphere_hit_batched():
    s = v4ray.shape.Sphere((0, 0, -5), 1.0)
    bb = s.bounding_box()
    assert np.allclose(bb.min, (-1, -1, -6))
    assert np.allclose(bb.max, (1, 1, -4))
    ray = v4ray.Ray(
        origin=[[0, 0, 0], [0, 0, 0]],
        direction=[[0, 0, -1], [0, 1, 0]],
    )
    rec = s.hit(ray, 1e-3, np.inf, device="cpu")
    assert rec.mask.tolist() == [True, False]
    assert np.isclose(rec.t[0], 4.0)
    assert rec.front_face[0]


def test_sphere_hit_matches_jax():
    """Sphere.hit on 1,024 seeded rays (origins around the sphere, unit
    directions, some inside it) against the JAX façade's: the mask equal,
    t to rtol 1e-5, widened per ray as tests/test_torch_intersect.py
    widens it, by the root's conditioning on grazing hits (|dt| <= 1e-5
    t + 4 ulp(|oc|^2) / sqrt(disc)); p, normal and uv where both hit to
    the same relative bound, front_face equal where t is."""
    import v4ray_tpu as jv4ray

    r = np.random.RandomState(0)
    n = 1024
    center, radius = (0.3, -0.2, -4.0), 1.5
    origin = r.uniform(-3.0, 3.0, (n, 3)).astype(np.float32)
    origin[:64] = np.asarray(center, np.float32) + r.uniform(-0.5, 0.5, (64, 3))  # inside
    target = np.asarray(center) + r.uniform(-2.0, 2.0, (n, 3))
    direction = (target - origin).astype(np.float32)
    direction /= np.linalg.norm(direction, axis=1, keepdims=True)
    mask = r.uniform(size=n) > 0.05
    ray = v4ray.Ray(origin, direction, mask=mask)
    jray = jv4ray.Ray(origin, direction, mask=mask)
    ours = v4ray.shape.Sphere(center, radius).hit(ray, 1e-3, np.inf, device="cpu")
    ref = jv4ray.shape.Sphere(center, radius).hit(jray, 1e-3, np.inf)

    np.testing.assert_array_equal(ours.mask, ref.mask)
    hit = ours.mask
    assert 200 < hit.sum() < n
    oc = origin.astype(np.float64) - np.asarray(center)
    half_b = (oc * direction).sum(axis=1)
    disc = half_b ** 2 - ((oc ** 2).sum(axis=1) - radius ** 2)
    ulp = np.spacing(np.float32((oc ** 2).sum(axis=1))).astype(np.float64)
    tol = 1e-5 * np.abs(ref.t) + 4 * ulp / np.sqrt(np.maximum(disc, 1e-30))
    assert (np.abs(ours.t - ref.t)[hit] <= tol[hit]).all()
    for name in ("p", "normal", "uv"):
        a, b = getattr(ours, name)[hit], getattr(ref, name)[hit]
        scale = 1e-5 + (tol[hit] * 4)[:, None]
        assert (np.abs(a - b) <= scale * np.maximum(1.0, np.abs(b))).all(), name
    same_t = hit & (ours.t == ref.t)
    np.testing.assert_array_equal(ours.front_face[same_t], ref.front_face[same_t])


def test_cuboid_and_medium_via_api():
    scene = v4ray.Scene(background=(1, 1, 1))
    iso = v4ray.material.Isotropic(v4ray.texture.SolidColor((1, 1, 1)))
    scene.add(
        v4ray.shape.ConstantMedium(v4ray.shape.Sphere((0, 0, 0), 1.0), 0.5), iso
    )
    scene.add(
        v4ray.shape.Cuboid((0, 0, 0), (1, 1, 1)),
        v4ray.material.Lambertian(v4ray.texture.SolidColor((0.5, 0.5, 0.5))),
    )
    data = scene.compile()
    assert data.n_medium == 1
    assert data.n_rects == 6


def test_frontend_sphere_plugin_roundtrip():
    from ray_tracing_tpu_torch.v4ray_frontend import shapes
    from ray_tracing_tpu_torch.v4ray_frontend.shape import Sphere

    assert Sphere in shapes
    data = [1.0, 2.0, 3.0, 4.0]
    assert Sphere.validate(data)
    assert not Sphere.validate([0.0, 0.0, 0.0, -1.0])
    j = Sphere.to_json(data)
    assert Sphere.from_json(j) == data
    built = Sphere.apply(data)
    assert len(built) == 1 and built[0].radius == 4.0
    assert isinstance(built[0], v4ray.shape.Sphere)


def test_frontend_texture_graph():
    from ray_tracing_tpu_torch.v4ray_frontend.texture import Checker, SolidColor

    t1, t2 = uuid4(), uuid4()
    solid_data = SolidColor.from_json({"color": "#ff8000"})
    assert solid_data == [(255, 128, 0)]
    assert SolidColor.to_json(solid_data)["color"] == "#ff8000"

    data = [t1, t2, 2.0]
    assert Checker.validate(data, {t1, t2})
    assert not Checker.validate(data, {t1})  # missing ref
    textures = {
        t1: SolidColor.apply(solid_data, {}),
        t2: SolidColor.apply([(0, 0, 255)], {}),
    }
    checker = Checker.apply(data, textures)
    assert checker.density == 2.0
    assert isinstance(checker, v4ray.texture.Checker)


def test_frontend_material_preview_standins():
    from ray_tracing_tpu_torch.v4ray_frontend.material import Dielectric, Metal

    prev = Dielectric.apply_preview([1.5], {})
    assert isinstance(prev, v4ray.material.Lambertian)
    prev = Metal.apply_preview([(255, 0, 0), 0.2], {})
    assert isinstance(prev, v4ray.material.Lambertian)
    real = Metal.apply([(255, 0, 0), 0.2], {})
    assert isinstance(real, v4ray.material.Metal)


def test_frontend_camera_validate_and_preview():
    from ray_tracing_tpu_torch.v4ray_frontend.camera import PerspectiveCamera

    data = PerspectiveCamera.from_json(
        {
            "look_from": [0, 0, -10], "look_at": [0, 0, 0], "vfov": 40,
            "up": [0, 1, 0], "aperture": 2.0, "focus_dist": 10.0,
            "time0": 0.0, "time1": 0.0,
        }
    )
    assert PerspectiveCamera.validate(data)
    cam = PerspectiveCamera.apply(data)
    assert cam.aperture == 2.0
    assert isinstance(cam, v4ray.PerspectiveCameraParam)
    prev = PerspectiveCamera.apply_preview(data)
    assert prev.aperture == 0.0  # pinhole preview
    bad = list(data)
    bad[6] = 200.0  # fov out of range
    assert not PerspectiveCamera.validate(bad)


def test_important_light_via_api():
    scene = v4ray.Scene(background=(0, 0, 0))
    scene.add_important(
        v4ray.shape.ZXRect(-1, 1, -1, 1, 2.0, positive=False),
        v4ray.material.DiffuseLight(v4ray.texture.SolidColor((5, 5, 5))),
    )
    data = scene.compile()
    assert data.n_lights == 1


def test_medium_generic_boundaries_via_api():
    scene = v4ray.Scene(background=(1, 1, 1))
    iso = v4ray.material.Isotropic(v4ray.texture.SolidColor((1, 1, 1)))
    scene.add(
        v4ray.shape.ConstantMedium(
            v4ray.shape.Cuboid((0, 0, 0), (1, 1, 1)), 0.2), iso
    )
    scene.add(
        v4ray.shape.ConstantMedium(
            v4ray.shape.XYRect(0, 1, 0, 1, -2.0), 0.4), iso
    )
    scene.add(
        v4ray.shape.ConstantMedium(
            v4ray.shape.Triangle([[0, 0, 0], [1, 0, 0], [0, 1, 0]]), 0.1),
        iso,
    )
    data = scene.compile()
    assert data.n_medium == 3


def test_shared_texture_builds_once():
    img = np.full((4, 4, 3), 128, np.uint8)
    tex = v4ray.texture.Image(img)
    s = v4ray.Scene(background=(0, 0, 0))
    s.add(v4ray.shape.Sphere((0, 0, -3), 1.0), v4ray.material.Lambertian(tex))
    s.add(v4ray.shape.Sphere((2, 0, -3), 1.0), v4ray.material.Isotropic(tex))
    scene = s.compile()
    assert scene.textures.images.shape[0] == 1  # not duplicated


def test_image_texture_reads_without_pillow(monkeypatch):
    """Image(path) decodes through models/compiler.py:load_image (the
    decoded .npy beside the file), so it works where Pillow is absent."""
    import sys

    monkeypatch.setitem(sys.modules, "PIL", None)
    tex = v4ray.texture.Image("data/earthmap.jpg")
    assert tex.image.dtype == np.uint8 and tex.image.shape == (512, 1024, 3)
    np.testing.assert_array_equal(tex.image, np.load("data/earthmap.npy"))


def test_moving_sphere_api_and_plugin():
    from ray_tracing_tpu_torch.v4ray_frontend import shapes
    from ray_tracing_tpu_torch.v4ray_frontend.shape import MovingSphere

    assert MovingSphere in shapes
    data = [-0.5, 0.0, -3.0, 0.5, 0.0, -3.0, 0.5, 0.0, 1.0]
    assert MovingSphere.validate(data)
    assert not MovingSphere.validate(data[:8] + [0.0])  # time1 == time0
    j = MovingSphere.to_json(data)
    assert MovingSphere.from_json(j) == data
    (shape,) = MovingSphere.apply(data)
    assert shape.radius == 0.5

    scene = v4ray.Scene(background=(0.2, 0.2, 0.2))
    scene.add(
        shape,
        v4ray.material.Lambertian(v4ray.texture.SolidColor((0.8, 0.2, 0.2))),
    )
    cam = v4ray.PerspectiveCameraParam(
        look_from=(0, 0, 1), look_at=(0, 0, -3), vfov=60,
        time0=0.0, time1=1.0,
    )
    renderer = v4ray.Renderer(
        v4ray.RendererParam(24, 24, max_depth=3), cam, scene, device="cpu"
    )
    img = asyncio.new_event_loop().run_until_complete(renderer.render())
    assert img.shape == (24, 24, 3)
    assert np.isfinite(img).all()
    assert (img[:, :, 0] - img[:, :, 1]).max() > 0.01


def test_user_defined_shape():
    class Ring:
        """User shape: N small spheres on a circle."""

        def __init__(self, center, radius, n=8, r_small=0.25):
            self.center, self.radius = center, radius
            self.n, self.r_small = n, r_small

        def _build(self, b, material, important):
            cx, cy, cz = self.center
            for i in range(self.n):
                a = 2 * math.pi * i / self.n
                b.add_sphere(
                    (cx + self.radius * math.cos(a), cy,
                     cz + self.radius * math.sin(a)),
                    self.r_small, material, important=important,
                )

    scene = v4ray.Scene(background=(0.6, 0.7, 0.9))
    red = v4ray.material.Lambertian(
        v4ray.texture.SolidColor((0.8, 0.2, 0.2)))
    scene.add(Ring((0.0, 0.0, -3.0), 1.2), red)
    compiled = scene.compile()
    assert compiled.n_spheres == 8

    r = v4ray.Renderer(
        v4ray.RendererParam(32, 32, 4),
        v4ray.PerspectiveCameraParam(
            look_from=(0, 2.5, 1.5), look_at=(0, 0, -3), vfov=60
        ),
        scene, device="cpu",
    )
    img = np.asarray(asyncio.run(r.render()))
    assert ((img[..., 0] - img[..., 2]) > 0.05).sum() > 10


def _every_shape(api):
    """One scene of every façade shape, material and texture, built with
    ``api`` (the port's v4ray or the JAX package's v4ray_tpu)."""
    s = api.Scene(background=(0.1, 0.2, 0.3), environment=(0.5, 0.5, 0.5))
    solid = api.texture.SolidColor((0.8, 0.3, 0.3))
    checker = api.texture.Checker(solid, api.texture.SolidColor((0.1, 0.9, 0.1)), 3.0)
    noise = api.texture.Noise(2.0, 5)
    image = api.texture.Image(np.arange(4 * 6 * 3, dtype=np.uint8).reshape(4, 6, 3))
    lam = api.material.Lambertian(checker)
    s.add(api.shape.Sphere((0, 0, -3), 1.0), lam)
    s.add(api.shape.Sphere((2, 0, -3), 0.5), api.material.Metal((0.9, 0.8, 0.7), 0.2))
    s.add(api.shape.Sphere((-2, 0, -3), 0.5), api.material.Dielectric(1.5))
    s.add(api.shape.Cuboid((-1, -2, -5), (1, -1, -4)), api.material.Lambertian(noise))
    s.add(api.shape.XYRect(-3, 3, -3, 3, -6.0), api.material.Lambertian(image))
    s.add(api.shape.YZRect(-1, 1, -5, -2, 3.0, positive=False), lam)
    s.add(api.shape.Triangle([[0, 1, -2], [1, 1, -2], [0, 2, -2]]), lam)
    s.add(api.shape.Mesh("data/bunny.obj"), api.material.Lambertian(solid))
    s.add(api.shape.ConstantMedium(api.shape.Sphere((0, 2, -3), 0.5), 0.7),
          api.material.Isotropic(solid))
    s.add_important(api.shape.ZXRect(-1, 1, -4, -2, 3.0, positive=False),
                    api.material.DiffuseLight(api.texture.SolidColor((4, 4, 4))))
    s.add_important(api.shape.Sphere((0, 5, -3), 0.3),
                    api.material.DiffuseLight(api.texture.SolidColor((2, 2, 2))))
    return s


def test_compiled_tables_equal_jax():
    """Every façade type through Scene.compile: the port's tables equal
    the JAX package's exactly (test_torch_scene._assert_tables_equal)."""
    import v4ray_tpu as jv4ray

    ours = _every_shape(v4ray).compile(noise_seed=2)
    ref = _every_shape(jv4ray).compile(noise_seed=2)
    assert ours.n_triangles > 4000 and ours.n_medium == 1 and ours.n_lights == 2
    _assert_tables_equal(ours, ref)

    moving = []
    for api in (v4ray, jv4ray):
        s = api.Scene(background=(0.2, 0.2, 0.2))
        s.add(api.shape.MovingSphere((-0.5, 0, -3), (0.5, 0, -3), 0.5, time0=0.0, time1=1.0),
              api.material.Lambertian(api.texture.SolidColor((0.8, 0.2, 0.2))))
        s.add(api.shape.Sphere((0, -100.5, -3), 100.0),
              api.material.Lambertian(api.texture.SolidColor((0.5, 0.5, 0.5))))
        moving.append(s.compile())
    assert moving[0].has_motion
    _assert_tables_equal(*moving)
