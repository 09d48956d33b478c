"""Phase A's cached tables (``SceneData.phase_a``, the layout of the
kernels K1, K3 and K4) and the plain version on them: the cached tables
equal a fresh pack and move with ``.to``; a transformed table's rows are
grouped by slot with each distinct transform once; ``phase_a_plain`` on
them gives the same bits as the per-row computation (one object ray per
row, argmin per table, strict < between tables); intersect_scene packs
nothing per bounce; and a large synthetic scene (5,000 spheres, 600
transformed rects over 3 transforms) agrees with the JAX package's
``intersect_scene`` on the CPU (its XLA phase A).  The kernels
themselves are held against the plain version on the card by
tests/test_torch_cuda.py and chip_smoke.py."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ray_tracing_tpu as jrt
import ray_tracing_tpu_torch as prt
from ray_tracing_tpu.ops import intersect as ji
from ray_tracing_tpu_torch import scenes
from ray_tracing_tpu_torch.models import scene as ms
from ray_tracing_tpu_torch.ops import cuda_intersect as ci
from ray_tracing_tpu_torch.ops import geometry as geo
from ray_tracing_tpu_torch.ops.intersect import intersect_scene
from test_torch_transform_media import _t_bound

torch.set_num_threads(2)

SCENES = {
    "zy": lambda: prt.load_scene_json("data/zy_scene.json").scene,
    "scene-json": lambda: prt.load_scene_json("data/scene.json").scene,
    "motion": lambda: scenes.motion_blur()[0],
}


@pytest.fixture(scope="module", params=sorted(SCENES))
def scene(request):
    return request.param, SCENES[request.param]()


def _rays(name, n, seed):
    """Rays through the scene's box (numpy, seeded) and shutter times."""
    r = np.random.RandomState(seed)
    lo, hi = ([-3, 0.1, -3], [3, 2.5, 3]) if name == "motion" else ([1, 1, 1], [554, 554, 554])
    ro = r.uniform(lo, hi, (n, 3)).astype(np.float32)
    rd = r.normal(size=(n, 3))
    rd = (rd / np.linalg.norm(rd, axis=1, keepdims=True)).astype(np.float32)
    return torch.from_numpy(ro), torch.from_numpy(rd), torch.from_numpy(
        r.uniform(0.0, 1.0, n).astype(np.float32))


def _per_row(sph, rect, ro, rd, t_min, t_max, t_ray=None):
    """Phase A on the per-row tables of pack_primitive_tables, as the
    plain version computed it before the kernels' layout: every
    transformed row its own object ray, argmin per table, a later table
    only with a strictly smaller t."""
    n = ro.shape[0]
    best = (torch.full((n,), np.inf), torch.full((n,), -1, dtype=torch.int32),
            torch.zeros((n,), dtype=torch.int32))
    for kind, table, cols in ((0, sph, ms.SPHERE_COLS), (2, rect, ms.RECT_COLS)):
        if table.shape[0] == 0:
            continue
        ro_n, rd_n, nrm, lo, hi = ro[:, None], rd[:, None], None, t_min, t_max
        if table.shape[1] == cols + ms.TF_COLS:
            inv = table[:, cols:cols + 9].reshape(-1, 3, 3)
            ro_n, rd_n, nrm = geo.transform_ray(inv, table[:, cols + 9:], ro_n, rd_n)
            lo, hi = t_min * nrm, t_max * nrm
            table = table[:, :cols]
        rows = torch.cat([table, torch.zeros((table.shape[0], ms.META_COLS))], dim=1)
        if kind == 0:
            t, mask = ci._sphere_grid(rows, ro_n, rd_n, lo, hi, t_ray)
        else:
            t, mask = ci._rect_grid(rows, ro_n, rd_n, lo, hi)
        if nrm is not None:
            t = t / nrm
        t = torch.where(mask, t, np.inf)
        idx = torch.argmin(t, dim=1)
        t = torch.gather(t, 1, idx[:, None])[:, 0]
        better = t < best[0]
        best = (torch.where(better, t, best[0]), torch.where(better, kind, best[1]),
                torch.where(better, idx.to(torch.int32), best[2]))
    return best


def test_cached_tables_equal_a_fresh_pack_and_move(scene):
    name, sc = scene
    fresh = ci.pack_phase_a_tables(*ci.pack_primitive_tables(sc))
    for f in dataclasses.fields(fresh):
        a, b = getattr(sc.phase_a, f.name), getattr(fresh, f.name)
        assert torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b, f.name
    moved = sc.to("meta").phase_a
    assert all(getattr(moved, f).device.type == "meta" for f in ("sph", "rect", "slots"))
    assert (sc.phase_a.sph_motion, sc.phase_a.rect_tf) == (name == "motion", name == "scene-json")


def test_transformed_rows_grouped_by_slot():
    """scene.json's 12 rects (6 walls in the identity slot, 6 cuboid faces
    in slot 1) in two groups, each row its base columns, its slot and
    its own row; the slot table holds the two distinct transforms."""
    sc = SCENES["scene-json"]()
    _, rect = ci.pack_primitive_tables(sc)
    tables = sc.phase_a
    meta = tables.rect[:, -ms.META_COLS:].contiguous().view(torch.int32)
    slot, row = meta[:, 0], meta[:, 1]
    assert tables.slots.shape == (2, ms.TF_COLS) and tables.rect_tf and not tables.sph_tf
    assert bool((slot[1:] >= slot[:-1]).all()) and sorted(row.tolist()) == list(range(12))
    assert torch.equal(tables.rect[:, :ms.RECT_COLS], rect[row.long(), :ms.RECT_COLS])
    assert torch.equal(tables.slots[slot.long()], rect[row.long(), ms.RECT_COLS:])
    for s in range(2):  # a slot's rows are in row order
        rows = row[slot == s]
        assert bool((rows[1:] > rows[:-1]).all())


def test_plain_on_grouped_tables_equals_per_row(scene):
    """2,048 rays: (t, kind, idx) bit-identical to the per-row layout."""
    name, sc = scene
    ro, rd, t_ray = _rays(name, 2048, 3)
    t_ray = t_ray if name == "motion" else None
    got = ci.phase_a_plain(sc.phase_a, ro, rd, 1e-3, np.inf, t_ray)
    want = _per_row(*ci.pack_primitive_tables(sc), ro, rd, 1e-3, np.inf, t_ray)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert int((got[1] >= 0).sum()) > 500


def test_intersect_scene_packs_nothing_per_bounce(monkeypatch):
    """A scene.json pass reads the cached tables: packing raises, and a
    scene without them is refused."""
    sc = SCENES["scene-json"]()
    cam = prt.load_scene_json("data/scene.json").camera

    def refuse(*_):
        raise AssertionError("phase-A tables packed during a render")

    want = prt.Renderer(prt.RendererParam(8, 8, max_depth=3), cam, sc, device="cpu").render(1)
    for fn in ("pack_primitive_tables", "pack_phase_a_tables"):
        monkeypatch.setattr(ms, fn, refuse)
        monkeypatch.setattr(ci, fn, refuse)
    got = prt.Renderer(prt.RendererParam(8, 8, max_depth=3), cam, sc, device="cpu").render(1)
    assert torch.equal(got, want)
    ro, rd, _ = _rays("scene-json", 16, 0)
    with pytest.raises(ValueError, match="phase-A tables"):
        intersect_scene(dataclasses.replace(sc, phase_a=None), ro, rd, 1e-3, np.inf)


def _large_scene(builder):
    """5,000 spheres and 600 rects, each rect under one of 3 transforms
    (a rotation about y and a translation each), in a 555 box."""
    r = np.random.RandomState(11)
    b = builder(background=(0.5, 0.6, 0.7))
    m = b.add_lambertian(b.add_texture_solid((0.7, 0.7, 0.7)))
    for c, rad in zip(r.uniform(20, 535, (5000, 3)), r.uniform(2.0, 9.0, 5000)):
        b.add_sphere(c, float(rad), m)
    transforms = []
    for th, t in ((15.0, (10, 0, -5)), (-40.0, (-20, 5, 30)), (70.0, (0, -10, 15))):
        a = np.deg2rad(th)
        rot = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]])
        transforms.append((rot, np.array(t, dtype=np.float64)))
    for i in range(600):
        a0, b0, k = r.uniform(40, 500, 3)
        b.add_rect(("xy", "yz", "zx")[i % 3], a0, a0 + r.uniform(5, 30), b0,
                   b0 + r.uniform(5, 30), k, m, positive=True, transform=transforms[i % 3])
    return b.build()


def test_large_scene_matches_jax_intersect():
    """512 rays against 5,000 spheres and 600 transformed rects (tables
    past 48 KB, past what K1-K4 once refused): winners equal the JAX package's
    intersect_scene on the CPU (its XLA phase A), t within the per-ray
    widened tolerance of tests/test_torch_transform_media.py."""
    ours, ref = _large_scene(prt.SceneBuilder), _large_scene(jrt.SceneBuilder)
    tables = ours.phase_a
    assert tables.slots.shape[0] == 3 and tables.rect.shape[0] == 600
    assert 4 * (tables.sph.numel() + tables.rect.numel()) > 48 * 1024
    ro, rd, _ = _rays("large", 512, 5)
    t, kind, idx = (x.numpy() for x in ci.phase_a_plain(tables, ro, rd, 1e-3, np.inf))
    hit = ji.intersect_scene(ref, jnp.asarray(ro.numpy()), jnp.asarray(rd.numpy()), 1e-3, jnp.inf)
    rt, rkind, ridx = (np.asarray(x) for x in (hit.t, hit.kind, hit.index))
    np.testing.assert_array_equal(kind, rkind)
    found = kind >= 0
    np.testing.assert_array_equal(idx[found], ridx[found])
    assert found.sum() > 200 and (kind == 2).sum() > 20
    sph, rect = (x.numpy() for x in ci.pack_primitive_tables(ours))
    dt = np.abs(t[found].astype(np.float64) - rt[found])
    bound = _t_bound(sph, rect, ro.numpy()[found], rd.numpy()[found], rt[found], kind[found],
                     idx[found])
    assert np.all(dt <= bound), (dt / bound).max()
