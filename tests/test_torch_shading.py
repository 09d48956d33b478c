"""The port's textures and material shading against the JAX package's:
both sides get the same hits, points and uniforms (numpy, seeded)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ray_tracing_tpu as jrt
import ray_tracing_tpu_torch as prt
from ray_tracing_tpu.ops.intersect import Hit as JHit
from ray_tracing_tpu.ops.intersect import intersect_scene as jintersect
from ray_tracing_tpu.ops.materials import shade as jshade
from ray_tracing_tpu.ops.textures import perlin_turb as jperlin_turb
from ray_tracing_tpu.ops.textures import texture_value as jtexture_value
from ray_tracing_tpu_torch.models.scene import (
    MAT_DIELECTRIC,
    MAT_DIFFUSE_LIGHT,
    MAT_LAMBERTIAN,
    MAT_METAL,
    TEX_CHECKER,
    TEX_IMAGE,
    TEX_NOISE,
    TEX_SOLID,
)
from ray_tracing_tpu_torch.ops.intersect import Hit
from ray_tracing_tpu_torch.ops.materials import N_SCATTER_U, emitted_color, scatter, shade
from ray_tracing_tpu_torch.ops.textures import perlin_turb, texture_value

torch.set_num_threads(2)

TOL = dict(rtol=1e-5, atol=1e-5)
EPS32 = float(np.finfo(np.float32).eps)


def _noise_atol(tt, leaf, p):
    """Per-ray absolute tolerance: 1e-5, widened on noise leaves.  XLA on
    the CPU fuses the noise domain map ``scale * p + offset`` into one
    FMA, PyTorch rounds the product and the sum apart, so the lattice
    point differs by up to half an ulp of |q|; octave i magnifies that by
    2**i and weights it by 2**-i, so each octave adds about
    slope * ulp(|q|) with the noise slope below ~2.  Bound: 4 * depth *
    eps * max|q|.  The noise itself is held at 1e-5 on a shared domain
    point by test_perlin_turb_matches_jax."""
    tt_np = {k: getattr(tt, k).numpy() for k in ("ttype", "scale", "noise_offset", "noise_depth")}
    q = tt_np["scale"][leaf][:, None] * p + tt_np["noise_offset"][leaf]
    widen = 4.0 * tt_np["noise_depth"][leaf] * EPS32 * np.abs(q).max(axis=1)
    return 1e-5 + np.where(tt_np["ttype"][leaf] == TEX_NOISE, widen, 0.0)


_CHECKER_SCENE = {
    "renderer": {"width": 8, "height": 8},
    "camera": {"look_from": [0, 0, -5], "look_at": [0, 0, 0], "vfov": 40},
    "objects": [{
        "shape": {"type": "sphere", "center": [0, 0, 0], "radius": 1},
        "material": {"type": "lambertian", "texture": {
            "type": "checker", "density": 0.1,
            "odd": {"type": "solid-color", "color": [0.1, 0.2, 0.3]},
            "even": {"type": "checker", "density": 0.37,
                     "odd": {"type": "solid-color", "color": [0.9, 0.8, 0.7]},
                     "even": {"type": "solid-color", "color": [0.4, 0.5, 0.6]}},
        }},
    }],
}


@pytest.fixture(scope="module")
def zy():
    return prt.load_scene_json("data/zy_scene.json"), jrt.load_scene_json("data/zy_scene.json")


def _texture_case(zy, name):
    """(port textures, JAX textures, texture index) for one texture kind."""
    if name == "checker":
        ours = prt.build_scene(_CHECKER_SCENE).scene.textures
        ref = jrt.build_scene(_CHECKER_SCENE).scene.textures
    else:
        ours, ref = zy[0].scene.textures, zy[1].scene.textures
    ttype = ours.ttype.numpy()
    want = {"solid": ttype == TEX_SOLID, "checker": ttype == TEX_CHECKER,
            "image": ttype == TEX_IMAGE,
            "noise6": (ttype == TEX_NOISE) & (ours.noise_depth.numpy() == 6),
            "noise10": (ttype == TEX_NOISE) & (ours.noise_depth.numpy() == 10)}[name]
    return ours, ref, np.flatnonzero(want)


@pytest.mark.parametrize("name", ["solid", "checker", "noise6", "noise10", "image"])
def test_texture_value_matches_jax(zy, name):
    ours, ref, candidates = _texture_case(zy, name)
    r = np.random.RandomState(7)
    n = 4096
    idx = r.choice(candidates, n).astype(np.int32)
    uv = r.uniform(0.0, 1.0, (n, 2)).astype(np.float32)
    p = r.uniform(-50.0, 600.0, (n, 3)).astype(np.float32)
    got = texture_value(ours, torch.from_numpy(idx), torch.from_numpy(uv), torch.from_numpy(p))
    want = np.asarray(jtexture_value(ref, jnp.asarray(idx), jnp.asarray(uv), jnp.asarray(p)))
    atol = _noise_atol(ours, idx, p)[:, None]
    assert np.all(np.abs(got.numpy() - want) <= atol + 1e-5 * np.abs(want))


@pytest.mark.parametrize("depth", [6, 10])
def test_perlin_turb_matches_jax(depth):
    """Turbulence on a shared domain point: the lattice hash, gradients,
    Hermite weights and octave sum of the port and of JAX."""
    r = np.random.RandomState(depth)
    q = r.uniform(-100.0, 400.0, (4096, 3)).astype(np.float32)
    d = r.randint(1, depth + 1, size=4096).astype(np.int32)
    got = perlin_turb(torch.from_numpy(q), torch.from_numpy(d), depth)
    want = jperlin_turb(None, jnp.asarray(q), jnp.asarray(d), depth)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.fixture(scope="module")
def hits(zy):
    """JAX hit records for camera-like and interior rays of zy, as numpy."""
    r = np.random.RandomState(3)
    n = 8192
    ro = np.concatenate([
        np.tile([[278.0, 278.0, -800.0]], (n // 2, 1)),
        r.uniform(1.0, 554.0, (n // 2, 3)),
    ]).astype(np.float32)
    d = np.concatenate([
        np.stack([r.uniform(-0.35, 0.35, n // 2), r.uniform(-0.35, 0.35, n // 2),
                  np.ones(n // 2)], -1),
        r.normal(size=(n // 2, 3)),
    ]).astype(np.float32)
    rd = d / np.linalg.norm(d, axis=1, keepdims=True)
    hit = jax.tree.map(np.asarray, jintersect(zy[1].scene, jnp.asarray(ro), jnp.asarray(rd), 1e-3, jnp.inf))
    u = r.uniform(0.0, 1.0, (n, N_SCATTER_U)).astype(np.float32)
    return hit, rd, u


@pytest.mark.parametrize(
    "mtype", [MAT_LAMBERTIAN, MAT_METAL, MAT_DIELECTRIC, MAT_DIFFUSE_LIGHT],
    ids=["lambertian", "metal", "dielectric", "diffuse-light"],
)
def test_shade_matches_jax(zy, hits, mtype):
    hit, rd, u = hits
    ours_scene, ref_scene = zy[0].scene, zy[1].scene
    sel = hit.mask & (ours_scene.materials.mtype.numpy()[hit.material] == mtype)
    assert sel.sum() >= 20
    fields = {f: np.ascontiguousarray(getattr(hit, f)[sel])
              for f in ("p", "normal", "t", "uv", "front_face", "mask", "material", "kind", "index")}
    hit_t = Hit(**{k: torch.from_numpy(v) for k, v in fields.items()})
    em, sc = shade(ours_scene, hit_t, torch.from_numpy(rd[sel]), torch.from_numpy(u[sel]))
    # shade is emitted_color + scatter sharing one texture evaluation
    assert torch.equal(em, emitted_color(ours_scene, hit_t))
    for a, b in zip(sc, scatter(ours_scene, hit_t, torch.from_numpy(rd[sel]), torch.from_numpy(u[sel]))):
        assert torch.equal(a, b)
    jem, jsc = jshade(ref_scene, JHit(**{k: jnp.asarray(v) for k, v in fields.items()}),
                      jnp.asarray(rd[sel]), jnp.asarray(u[sel]))
    np.testing.assert_allclose(em.numpy(), np.asarray(jem), **TOL)
    np.testing.assert_array_equal(sc.scattered.numpy(), np.asarray(jsc.scattered))
    np.testing.assert_allclose(sc.direction.numpy(), np.asarray(jsc.direction), **TOL)
    # coef = texture * MIS weight (at most 2): noise lanes take the
    # texture's tolerance twice over
    leaf = ours_scene.materials.tex.numpy()[fields["material"]]
    atol = 2.0 * _noise_atol(ours_scene.textures, leaf, fields["p"])[:, None]
    want = np.asarray(jsc.coef)
    assert np.all(np.abs(sc.coef.numpy() - want) <= atol + 1e-5 * np.abs(want))
