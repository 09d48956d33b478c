"""Material shading, the PyTorch counterpart of
``ray_tracing_tpu/ops/materials.py``: emission and scatter for a whole
ray wavefront.  Every ray evaluates the closed forms of all material
models and selects by material type (reference src/renderer.rs:204-274).

Scatter consumes a fixed block of uniforms per bounce; the column
layout below is part of the renderer's reproducibility contract and is
the JAX package's.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ray_tracing_tpu_torch.models.scene import (
    MAT_DIELECTRIC,
    MAT_DIFFUSE_LIGHT,
    MAT_LAMBERTIAN,
    MAT_METAL,
    TEX_IMAGE,
    TEX_SOLID,
    SceneData,
)
from ray_tracing_tpu_torch.ops import geometry as geo
from ray_tracing_tpu_torch.ops import sampling as smp
from ray_tracing_tpu_torch.ops.intersect import Hit
from ray_tracing_tpu_torch.ops.lights import lights_generate, lights_value
from ray_tracing_tpu_torch.ops.textures import image_texel_index, texture_value

# uniform column layout for one bounce's scatter block
U_COS_1 = 0  # cosine-pdf generate r1 (reference cosine.rs:39)
U_COS_2 = 1  # cosine-pdf generate r2
U_MIX_SELECT = 2  # mixture pdf branch (reference mixture.rs:28)
U_LIGHT_PICK = 3  # which light (reference group.rs:93)
U_LIGHT_1 = 4  # light-sample draw 1 (cone phi / rect a)
U_LIGHT_2 = 5  # light-sample draw 2
U_FUZZ_1 = 6  # metal in_unit_sphere theta (reference random.rs:53-65)
U_FUZZ_2 = 7  # metal in_unit_sphere cos_phi
U_FUZZ_3 = 8  # metal in_unit_sphere radius
U_DIELECTRIC = 9  # Schlick russian roulette (reference dielectric.rs:46)
U_ISO_1 = 10  # isotropic on_unit_sphere z
U_ISO_2 = 11  # isotropic on_unit_sphere theta
N_SCATTER_U = 12


class Scatter(NamedTuple):
    direction: torch.Tensor  # (N, 3) unit
    coef: torch.Tensor  # (N, 3) throughput multiplier
    scattered: torch.Tensor  # (N,) bool, False = path terminates


def emitted_color(scene: SceneData, hit: Hit) -> torch.Tensor:
    """Emission at a hit: only diffuse-light emits, one-sided (reference
    diffuse_light.rs:18-23)."""
    tex = texture_value(scene.textures, scene.materials.tex[hit.material], hit.uv, hit.p)
    return _emitted_given_tex(scene, hit, tex)


def _emitted_given_tex(scene: SceneData, hit: Hit, tex):
    mtype = scene.materials.mtype[hit.material]
    is_light = (mtype == MAT_DIFFUSE_LIGHT) & hit.front_face
    return torch.where(is_light[..., None], tex, 0.0)


class ShadeAux(NamedTuple):
    """Per-ray shading facts for path-replay backpropagation
    (render/prb_tape.py): which color-table entry fed this bounce."""

    leaf_tex: torch.Tensor  # (N,) i64 resolved texture leaf id
    leaf_is_solid: torch.Tensor  # (N,) bool, the leaf reads textures.color
    tex_value: torch.Tensor  # (N, 3) the evaluated texture color
    leaf_is_image: torch.Tensor  # (N,) bool, the leaf reads textures.images
    texel: torch.Tensor  # (N,) i32 flat atlas index (img*Hmax + j)*Wmax + i


def shade(scene: SceneData, hit: Hit, rd_in, u, with_aux: bool = False):
    """Fused emission + scatter: the hit's material texture is evaluated
    once for both.  Returns (emitted (N, 3), Scatter[, ShadeAux])."""
    tt = scene.textures
    tex, leaf = texture_value(tt, scene.materials.tex[hit.material], hit.uv, hit.p,
                              with_leaf=True)
    out = _emitted_given_tex(scene, hit, tex), _scatter_given_tex(scene, hit, rd_in, u, tex)
    if not with_aux:
        return out
    ttype = tt.ttype[leaf]
    if tt.images.shape[0] > 0:
        leaf_is_image = ttype == TEX_IMAGE
        img = tt.image[leaf]
        j, i = image_texel_index(tt, img, hit.uv)
        hmax, wmax = tt.images.shape[1], tt.images.shape[2]
        texel = (img * hmax + j) * wmax + i
    else:
        leaf_is_image = torch.zeros_like(ttype, dtype=torch.bool)
        texel = torch.zeros_like(ttype)
    aux = ShadeAux(
        leaf_tex=leaf,
        leaf_is_solid=ttype == TEX_SOLID,
        tex_value=tex,
        leaf_is_image=leaf_is_image,
        texel=texel,
    )
    return out + (aux,)


def scatter(scene: SceneData, hit: Hit, rd_in, u) -> Scatter:
    """One scatter decision per ray (reference renderer.rs:231-263).

    rd_in: (N, 3) unit incoming directions; u: (N, N_SCATTER_U)
    uniforms.  Scatter materials mix the material pdf with the light pdf
    50/50 and weight by p_material / p_mixture; specular materials pass
    their attenuation through."""
    tex = texture_value(scene.textures, scene.materials.tex[hit.material], hit.uv, hit.p)
    return _scatter_given_tex(scene, hit, rd_in, u, tex)


def _scatter_given_tex(scene: SceneData, hit: Hit, rd_in, u, tex) -> Scatter:
    mat = scene.materials
    mtype = mat.mtype[hit.material]
    n = hit.normal

    # lambertian (reference lambertian.rs:36-47)
    cos_dir = smp.cosine_pdf_generate(n, u[:, U_COS_1], u[:, U_COS_2])
    if scene.has_lights:
        light_dir = lights_generate(
            scene, hit.p, u[:, U_LIGHT_PICK], u[:, U_LIGHT_1], u[:, U_LIGHT_2]
        )
        mix_dir = torch.where((u[:, U_MIX_SELECT] < 0.5)[..., None], light_dir, cos_dir)
        p_mat = smp.cosine_pdf_value(n, mix_dir)
        p_light = lights_value(scene, hit.p, mix_dir)
        p_mix = 0.5 * p_light + 0.5 * p_mat
        # the division is guarded so that reverse-mode AD of the dense
        # trace sees no 0 * inf on the lanes the where drops
        mixed = p_mix > 0.0
        weight = torch.where(mixed, p_mat / torch.where(mixed, p_mix, 1.0), 0.0)
        lamb_dir = mix_dir
        lamb_coef = tex * weight[..., None]
    else:
        lamb_dir = cos_dir
        lamb_coef = tex

    # metal (reference metal.rs:31-46)
    reflected = smp.reflect(rd_in, n)
    fuzz_vec = smp.random_in_unit_sphere(u[:, U_FUZZ_1], u[:, U_FUZZ_2], u[:, U_FUZZ_3])
    metal_dir = geo.normalize(reflected + fuzz_vec * mat.fuzz[hit.material][..., None])
    metal_coef = mat.albedo[hit.material]

    # dielectric (reference dielectric.rs:33-60)
    ir = mat.ir[hit.material]
    ratio = torch.where(hit.front_face, 1.0 / torch.clamp_min(ir, 1e-8), ir)
    cos_theta = -geo.dot(rd_in, n)
    sin_theta = geo.safe_sqrt(1.0 - cos_theta * cos_theta)
    cannot_refract = (ratio * sin_theta) > 1.0
    cannot_refract = cannot_refract | (
        smp.schlick_reflectance(cos_theta, ratio) > u[:, U_DIELECTRIC]
    )
    diel_dir = torch.where(
        cannot_refract[..., None], reflected, smp.refract(rd_in, n, ratio)
    )

    # isotropic, every remaining scattering type (reference isotropic.rs:26-43)
    iso_dir = smp.random_on_unit_sphere(u[:, U_ISO_1], u[:, U_ISO_2])

    is_lamb = (mtype == MAT_LAMBERTIAN)[..., None]
    is_metal = (mtype == MAT_METAL)[..., None]
    is_diel = (mtype == MAT_DIELECTRIC)[..., None]
    direction = torch.where(
        is_lamb, lamb_dir,
        torch.where(is_metal, metal_dir, torch.where(is_diel, diel_dir, iso_dir)),
    )
    coef = torch.where(
        is_lamb, lamb_coef,
        torch.where(is_metal, metal_coef, torch.where(is_diel, torch.ones_like(lamb_coef), tex)),
    )
    return Scatter(direction=direction, coef=coef, scattered=mtype != MAT_DIFFUSE_LIGHT)
