"""Tests of the port that need an NVIDIA GPU: K1 to K6 against their
plain versions on the card (K1, K3 and K4 also on tables past 48 KB and
past what shared memory holds; K5 over a table above 32,768 triangles
without clusters, and the brute-force grid against K5; K2 bit for bit
against its plain version run on the CPU, and repeatable), the
render and gradient paths on the card (the card's one tile against
tiles of 65,536 among them; the fuzz / IR replay's CUDA graphs against
the eager replay, and their kernels' launch counts against the
profiler's), and multicard_torch.py with one
NCCL rank on each card present.  They skip without a GPU.  The
file imports no JAX, so on a machine with a GPU and without JAX it runs
on its own:

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

import ray_tracing_tpu_torch as prt
from ray_tracing_tpu_torch import scenes
from ray_tracing_tpu_torch.models.camera import Camera, camera_rays
from ray_tracing_tpu_torch.ops import _build
from ray_tracing_tpu_torch.ops import cuda_intersect as ci
from ray_tracing_tpu_torch.ops import cuda_scatter as cs
from ray_tracing_tpu_torch.ops import cuda_triangles as ct
from ray_tracing_tpu_torch.ops import geometry as geo
from ray_tracing_tpu_torch.ops import rng
from ray_tracing_tpu_torch.render.prb_scalar import params_of, prb_loss_and_grad_all
from test_torch_tile import dense_pass

pytestmark = pytest.mark.cuda

ZY = "data/zy_scene.json"
SCENE = "data/scene.json"


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (K1 and K2 have no CPU mode)")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def zy():
    return prt.load_scene_json(ZY)


@pytest.fixture(scope="module")
def scene_json():
    return prt.load_scene_json(SCENE)


def _ray_sets(bundle, device):
    ro, rd, _, _ = camera_rays(Camera.build(bundle.camera, 1.0).to(device), rng.key(3), 128, 128)
    r = np.random.RandomState(0)
    iro = r.uniform(1.0, 554.0, (5000, 3)).astype(np.float32)  # ragged tail
    ird = r.normal(size=(5000, 3)).astype(np.float32)
    ird /= np.linalg.norm(ird, axis=1, keepdims=True)
    return [(ro, rd), (torch.from_numpy(iro).to(device), torch.from_numpy(ird).to(device))]


def _assert_phase_a_equal(got, want):
    """found, kind and idx equal, t bit-equal."""
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
    assert torch.equal(got[0], want[0])


def test_kernel_matches_plain_on_card(cuda, zy):
    tables = zy.scene.to(cuda).phase_a
    for ro, rd in _ray_sets(zy, cuda):
        before = ci.LAUNCHES
        got = ci.phase_a_cuda(tables, ro, rd, 1e-3, np.inf)
        torch.cuda.synchronize()
        assert ci.LAUNCHES == before + 1
        _assert_phase_a_equal(got, ci.phase_a_plain(tables, ro, rd, 1e-3, np.inf))


def test_kernel_refuses_bad_inputs(cuda, zy):
    tables = zy.scene.to(cuda).phase_a
    ro, rd = _ray_sets(zy, cuda)[1]
    with pytest.raises(ValueError, match="contiguous"):
        ci.phase_a_cuda(tables, ro.t().contiguous().t(), rd, 1e-3, np.inf)
    with pytest.raises(ValueError, match="is on"):
        ci.phase_a_cuda(zy.scene.phase_a, ro, rd, 1e-3, np.inf)
    with pytest.raises(TypeError, match="float32"):
        ci.phase_a_cuda(tables, ro.double(), rd, 1e-3, np.inf)
    empty = torch.zeros((0, 3), device=cuda)
    before = ci.LAUNCHES
    assert all(x.numel() == 0 for x in ci.phase_a_cuda(tables, empty, empty, 1e-3, np.inf))
    assert ci.LAUNCHES == before


def test_render_on_card(cuda, zy):
    param = prt.RendererParam(96, 96, max_depth=10)
    compact = prt.Renderer(param, zy.camera, zy.scene, device=cuda)
    before = ci.LAUNCHES
    img = compact.render(4)
    assert ci.LAUNCHES > before
    assert img.device.type == "cuda" and torch.isfinite(img).all() and (img >= 0).all()
    assert torch.equal(img, dense_pass(compact, 4)[0])
    assert torch.equal(img, compact.render(4))
    one = prt.RendererParam(96, 96, max_depth=1)
    on_card = prt.Renderer(one, zy.camera, zy.scene, device=cuda).render(4).cpu()
    on_cpu = prt.Renderer(one, zy.camera, zy.scene, device="cpu").render(4)
    assert (on_card == on_cpu).all(dim=-1).float().mean() >= 0.999


def test_both_kernels_build_through_the_shared_builder(cuda):
    libs = [_build.build(source) for source in (ci.SOURCE, cs.SOURCE, ct.SOURCE)]
    assert [lib.name.split("_")[0] for lib in libs] == ["intersect", "scatter", "triangles"]
    assert all(lib.exists() and lib.parent == _build.BUILD_DIR for lib in libs)


def _scatter_rows(n, p, seed, device):
    r = np.random.RandomState(seed)
    texel = np.where(r.rand(n) < 0.5, r.randint(0, 64, n), r.randint(-1, p, n)).astype(np.int32)
    contrib = r.uniform(0.0, 1.0, (n, 3)).astype(np.float32)
    mask = r.rand(n) < 0.3
    return [torch.from_numpy(x).to(device) for x in (texel, contrib, mask)]


def _k2_against_cpu(p, segments, base=None):
    """K2 into a (p, 3) table on the card, twice, against
    scatter_add_plain on the CPU over the same rows: both runs equal it
    bit for bit.  Returns the number of launches of one call."""
    base = torch.zeros((p, 3)) if base is None else base
    device = segments[0][0].device
    before = cs.LAUNCHES
    got = cs.scatter_add_cuda(base.to(device), segments)
    torch.cuda.synchronize()
    launches = cs.LAUNCHES - before
    again = cs.scatter_add_cuda(base.to(device), segments)
    want = cs.scatter_add_plain(base.clone(), [tuple(x.cpu() for x in s) for s in segments])
    assert torch.equal(got.cpu(), want) and torch.equal(again, got)
    return launches


def test_scatter_kernel_matches_plain_on_card(cuda):
    """Heavy duplicates (half the rows on 64 texels), texel -1 rows and a
    ragged row count, as one segment and cut into three: bit-equal to the
    plain version run on the CPU, and the same bits twice; rows without
    duplicates too."""
    p = 4099
    texel, contrib, mask = _scatter_rows(100_003, p, 0, cuda)
    base = torch.from_numpy(np.random.RandomState(3).uniform(0, 1, (p, 3)).astype(np.float32))
    assert _k2_against_cpu(p, [(texel, contrib, mask)], base) == 1
    cuts = (0, 40_000, 40_001, 100_003)
    segments = [(texel[a:b], contrib[a:b], mask[a:b]) for a, b in zip(cuts[:-1], cuts[1:])]
    assert _k2_against_cpu(p, segments, base) == 1
    unique = torch.randperm(p, device=cuda)[:1000].to(torch.int32)
    rows = (unique, contrib[:1000].contiguous(), torch.ones(1000, dtype=torch.bool, device=cuda))
    once = cs.scatter_add(torch.zeros((p, 3), device=cuda), [rows])
    assert torch.equal(once, cs.scatter_add_plain(torch.zeros((p, 3), device=cuda), [rows]))


def test_scatter_kernel_deterministic_all_live(cuda):
    """All rows live: 300,017 rows over 3 segments, on 50,000 texels (a
    few rows each, most in one block's run), on 5,000 (runs in many
    blocks) and on one (a run in every block), and 2,500,000 rows on 3
    texels, which the wrapper cuts into two calls: bit-equal to the
    CPU's plain version and repeatable."""
    r = np.random.RandomState(4)
    for p, texels, n, calls in ((60_000, 50_000, 300_017, 1), (5000, 5000, 300_017, 1),
                                (7, 1, 300_017, 1), (5, 3, 2_500_000, 2)):
        texel = torch.from_numpy(r.randint(0, texels, n).astype(np.int32)).to(cuda)
        contrib = torch.from_numpy(r.uniform(-1, 1, (n, 3)).astype(np.float32)).to(cuda)
        mask = torch.ones(n, dtype=torch.bool, device=cuda)
        cuts = (0, 100_000, 250_000, n)
        assert _k2_against_cpu(p, [(texel[a:b], contrib[a:b], mask[a:b])
                                   for a, b in zip(cuts[:-1], cuts[1:])]) == calls


def test_scatter_kernel_refuses_bad_inputs(cuda):
    texel, contrib, mask = _scatter_rows(1000, 64, 1, cuda)
    g = torch.zeros((64, 3), device=cuda)
    with pytest.raises(TypeError, match="int32"):
        cs.scatter_add_cuda(g, [(texel.long(), contrib, mask)])
    with pytest.raises(ValueError, match="contiguous"):
        cs.scatter_add_cuda(g, [(texel, contrib.t().contiguous().t(), mask)])
    with pytest.raises(ValueError, match="is on"):
        cs.scatter_add_cuda(g, [(texel.cpu(), contrib, mask)])
    with pytest.raises(ValueError, match="shape"):
        cs.scatter_add_cuda(g, [(texel[:10], contrib, mask)])
    with pytest.raises(TypeError, match="bool"):
        cs.scatter_add_cuda(g, [(texel, contrib, mask.to(torch.uint8))])
    before = cs.LAUNCHES
    empty = texel[:0], contrib[:0], mask[:0]
    assert cs.scatter_add_cuda(g, [empty]) is g and cs.scatter_add_cuda(g, []) is g
    assert cs.LAUNCHES == before


def _card_and_cpu_grads(bundle, cuda, size, depth, leaves):
    """run(device, seed) of the fwd+bwd at ``size``^2 and ``depth``: the
    loss and the ``leaves`` on the CPU, and the counts of the kernels
    launched (K1, K2, K3, K5)."""
    cam = Camera.build(bundle.camera, 1.0)

    def run(device, seed):
        scene = bundle.scene.to(device)
        ro, rd, _, k_trace = camera_rays(cam.to(device), rng.key(seed), size, size)
        before = (ci.LAUNCHES, cs.LAUNCHES, ci.TF_LAUNCHES, ct.LAUNCHES)
        loss, grads = prb_loss_and_grad_all(torch.mean, params_of(scene), scene, ro, rd,
                                            k_trace, depth)
        assert all(torch.isfinite(g).all() for g in grads)
        after = (ci.LAUNCHES, cs.LAUNCHES, ci.TF_LAUNCHES, ct.LAUNCHES)
        return ([loss.cpu()] + [getattr(grads, f).cpu() for f in leaves],
                tuple(a - b for a, b in zip(after, before)))

    return run


def _inside_noise_floor(names, on_card, on_cpu, other):
    for name, a, b, c in zip(names, on_card, on_cpu, other):
        matched = float((a - b).abs().sum())
        floor = float((a - c).abs().sum())
        assert floor > 0 and matched <= 0.6 * floor, (name, matched, floor)


def test_gradient_pass_on_card_matches_cpu(cuda, zy):
    """zy at 96x96 depth 6: the loss and the color-linear gradients
    (color, images, metal_albedo, all three K2's) on the card against the
    port's CPU run at the same key, and K2 launched on the card.  A few
    paths part where the card's and the CPU's transcendentals round
    differently, so each quantity is held to the card's own noise floor:
    its difference to the CPU at the same key is at most 0.6x its
    difference between two keys.  A second card run at the same key
    repeats the loss and every color-linear leaf bit for bit."""
    leaves = ("color", "images", "metal_albedo")
    run = _card_and_cpu_grads(zy, cuda, 96, 6, leaves)
    on_cpu, k_cpu = run("cpu", 4)
    on_card, k_card = run(cuda, 4)
    again, _ = run(cuda, 4)
    other, _ = run(cuda, 5)
    assert k_cpu[1] == 0 and k_card[1] > 0
    _inside_noise_floor(("loss",) + leaves, on_card, on_cpu, other)
    for name, a, b in zip(("loss",) + leaves, on_card, again):
        assert torch.equal(a, b), name


def test_scene_json_gradient_on_card_matches_cpu(cuda, scene_json):
    """data/scene.json at 64x64 depth 6: the loss and all five leaves on
    the card against the port's CPU run at the same key, held to the
    card's own noise floor as above; K2, K3 and K5 launched on the card;
    a second card run at the same key repeats the loss and all five
    leaves bit for bit (the fuzz / IR replay's backward included)."""
    leaves = ("color", "images", "metal_albedo", "fuzz", "ir")
    run = _card_and_cpu_grads(scene_json, cuda, 64, 6, leaves)
    on_cpu, k_cpu = run("cpu", 4)
    on_card, k_card = run(cuda, 4)
    again, _ = run(cuda, 4)
    other, _ = run(cuda, 5)
    assert k_cpu == (0, 0, 0, 0) and k_card[1] == 1 and k_card[2] > 0 and k_card[3] > 0
    _inside_noise_floor(("loss",) + leaves, on_card, on_cpu, other)
    for name, a, b in zip(("loss",) + leaves, on_card, again):
        assert torch.equal(a, b), name


def _bunny_rays(n, seed, device):
    """Rays from around the box aimed at scene.json's bunny (x 250-360,
    y 30-190, z 140-270 after its transform)."""
    r = np.random.RandomState(seed)
    ro = r.uniform(20.0, 535.0, (n, 3)).astype(np.float32)
    target = r.uniform([250, 30, 140], [360, 190, 270], (n, 3)).astype(np.float32)
    rd = target - ro
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    return torch.from_numpy(ro).to(device), torch.from_numpy(rd).to(device)


def test_transformed_kernel_matches_plain_on_card(cuda, scene_json):
    """K3 (scene.json's rects carry transforms) against phase_a_plain:
    kind and idx equal, t bit-equal, and some winners on the rotated
    cuboid."""
    tables = scene_json.scene.to(cuda).phase_a
    assert tables.rect_tf and tables.slots.shape[0] == 2
    for ro, rd in _ray_sets(scene_json, cuda):
        before = (ci.LAUNCHES, ci.TF_LAUNCHES)
        got = ci.phase_a_cuda(tables, ro, rd, 1e-3, np.inf)
        torch.cuda.synchronize()
        assert (ci.LAUNCHES, ci.TF_LAUNCHES) == (before[0], before[1] + 1)
        _assert_phase_a_equal(got, ci.phase_a_plain(tables, ro, rd, 1e-3, np.inf))
        assert int(((got[1] == 2) & (got[2] < 6)).sum()) > 0


def _large_tables(kernel, n_sph, n_rect, seed=0):
    """Seeded per-row tables of ``n_sph`` spheres and ``n_rect`` rects in
    the 555 box, in the kernels' layout on the CPU: for "K3" each rect
    under one of three transforms, for "K4" the spheres moving."""
    r = np.random.RandomState(seed)
    sph = np.concatenate([r.uniform(20, 535, (n_sph, 3)), r.uniform(1.0, 6.0, (n_sph, 1))], 1)
    if kernel == "K4":
        sph = np.concatenate([sph, r.uniform(-20, 20, (n_sph, 3))], 1)
    axis = torch.from_numpy(r.randint(0, 3, n_rect))
    lo = r.uniform(40, 500, (n_rect, 2))
    bounds = np.stack([lo[:, 0], lo[:, 0] + r.uniform(5, 30, n_rect), lo[:, 1],
                       lo[:, 1] + r.uniform(5, 30, n_rect), r.uniform(40, 500, n_rect)], 1)
    rect = torch.cat([*geo.rect_basis(axis), torch.from_numpy(bounds).float()], 1)
    if kernel == "K3":
        slots = []
        for th in (15.0, -40.0, 70.0):
            a = np.deg2rad(th)
            inv = np.array([[np.cos(a), 0, -np.sin(a)], [0, 1, 0], [np.sin(a), 0, np.cos(a)]])
            slots.append(np.concatenate([inv.ravel(), r.uniform(-30, 30, 3)]))
        rect = torch.cat([rect, torch.from_numpy(np.array(slots)[np.arange(n_rect) % 3]).float()],
                         1)
    return ci.pack_phase_a_tables(torch.from_numpy(sph).float().contiguous(),
                                  rect.contiguous())


@pytest.mark.parametrize("case", ["K1 past 48 KB", "K1 past shared memory",
                                  "K3 past 48 KB", "K3 past shared memory",
                                  "K4 past shared memory"])
def test_phase_a_kernels_on_large_tables(cuda, case):
    """Tables past the 48 KB a block gets without opting in (5,000
    spheres, 2,500 transformed rects over 3 transforms) and past the
    227 KB it may opt in to (15,000 spheres, 4,000 transformed rects,
    15,000 moving spheres; streamed in chunks): found, kind and idx
    equal to phase_a_plain, t bit-equal, on rays from inside the box."""
    sizes = {"K1 past 48 KB": (5000, 60), "K1 past shared memory": (15_000, 60),
             "K3 past 48 KB": (30, 2500), "K3 past shared memory": (30, 4000),
             "K4 past shared memory": (15_000, 60)}[case]
    host = _large_tables(case[:2], *sizes)
    assert (host.rect_tf, host.sph_motion) == (case[:2] == "K3", case[:2] == "K4")
    nbytes = 4 * (host.sph.numel() + host.rect.numel())
    assert nbytes > (227 * 1024 if "shared memory" in case else 48 * 1024)
    tables = host.to(cuda)
    r = np.random.RandomState(1)
    ro = torch.from_numpy(r.uniform(1.0, 554.0, (4099, 3)).astype(np.float32)).to(cuda)
    rd = torch.from_numpy(r.normal(size=(4099, 3)).astype(np.float32)).to(cuda)
    rd = (rd / rd.norm(dim=1, keepdim=True)).contiguous()
    t_ray = torch.from_numpy(r.uniform(0, 1, 4099).astype(np.float32)).to(cuda)
    got = ci.phase_a_cuda(tables, ro, rd, 1e-3, np.inf, t_ray)
    torch.cuda.synchronize()
    want = ci.phase_a_plain(tables, ro, rd, 1e-3, np.inf, t_ray)
    _assert_phase_a_equal(got, want)
    assert int((got[1] == (2 if case.startswith("K3") else 0)).sum()) > 100


def _assert_same_winners(got, want):
    """found and idx equal, t bit-equal on hits."""
    assert torch.equal(got[2], want[2])
    assert torch.equal(got[1][got[2]], want[1][want[2]])
    assert torch.equal(got[0][got[2]], want[0][want[2]])


def _k5(tr, ro, rd, t_max=np.inf):
    before = ct.LAUNCHES
    got = ct.triangle_sweep_cuda(tr.sw_table, tr.sw_aabb, tr.sw_origin, ro, rd, 1e-3, t_max)
    torch.cuda.synchronize()
    assert ct.LAUNCHES == before + 1
    return got


def _secondary(tr, ro, rd):
    """chip_smoke.secondary_rays from the mesh hits of (ro, rd)."""
    from chip_smoke import secondary_rays

    hit = ct.triangle_sweep_plain(tr.sw_table, tr.sw_origin, ro, rd, 1e-3, np.inf)
    return secondary_rays(tr, ro, rd, *hit, 6007, 1)


def test_triangle_kernel_matches_plain_on_card(cuda, scene_json):
    """K5 against triangle_sweep_plain (dense, no cull) on scene.json's
    4,969 triangles: found and idx equal, t bit-equal on hits, camera
    rays, rays aimed at the bunny (with a ragged tail) and secondary rays
    from the camera rays' mesh hits."""
    tr = scene_json.scene.triangles.to(cuda)
    cam = _ray_sets(scene_json, cuda)[0]
    for ro, rd in (cam, _bunny_rays(5003, 1, cuda), _secondary(tr, *cam)):
        got = _k5(tr, ro, rd)
        _assert_same_winners(got, ct.triangle_sweep_plain(tr.sw_table, tr.sw_origin, ro, rd,
                                                          1e-3, np.inf))
        assert got[2].float().mean() > 0.01


def _tie_table(tr):
    """scene.json's triangles after one cluster of 128 copies of bunny
    triangle ``j``: every hit on it ties between indices 0..127 and
    128 + j, and the original's larger cluster box is entered first, so
    the front-to-back order meets the lowest index last."""
    import dataclasses

    from ray_tracing_tpu_torch.models.scene import (
        pack_sweep_kernel_tables,
        pack_triangle_clusters,
        pack_triangle_sweep,
    )

    j = 2000
    fields = ("v0", "e12", "e13", "n0", "n1", "n2", "uv0", "uv1", "uv2", "material")
    table = dataclasses.replace(tr, **{f: torch.cat([getattr(tr, f)[j:j + 1].expand(
        128, *getattr(tr, f).shape[1:]), getattr(tr, f)]) for f in fields})
    plain = dataclasses.replace(table, **{f.name: None for f in dataclasses.fields(table)
                                          if f.name.startswith(("sw_", "cl_"))})
    return pack_triangle_clusters(pack_sweep_kernel_tables(pack_triangle_sweep(plain))), j


def test_sweep_kernels_break_out_of_order_ties_by_index(cuda, scene_json):
    """K5 and K6 against the dense plain version (and K6 against
    cluster_sweep_plain) on a table whose hits tie across two clusters:
    the lowest index wins, whatever order the clusters are visited in."""
    tr, j = _tie_table(scene_json.scene.triangles)
    tr = tr.to(cuda)
    r = np.random.RandomState(5)
    target = (tr.v0[0] + (tr.e12[0] + tr.e13[0]) / 3.0).cpu().numpy()
    ro = r.uniform(20.0, 535.0, (3001, 3)).astype(np.float32)
    rd = target + r.normal(size=(3001, 3)).astype(np.float32) * 0.2 - ro
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    ro, rd = torch.from_numpy(ro).to(cuda), torch.from_numpy(rd.astype(np.float32)).to(cuda)
    want = ct.triangle_sweep_plain(tr.sw_table, tr.sw_origin, ro, rd, 1e-3, np.inf)
    on_copy = want[2] & ((want[1] < 128) | (want[1] == 128 + j))
    assert int(on_copy.sum()) > 100 and bool((want[1][on_copy] == 0).all())  # ties won by 0
    _assert_same_winners(_k5(tr, ro, rd), want)
    got = ct.cluster_sweep_cuda(tr.sw_table, tr.sw_aabb, tr.sw_origin, ro, rd, 1e-3, np.inf)
    _assert_same_winners(got, want)
    _assert_same_winners(got, ct.cluster_sweep_plain(tr, ro, rd, 1e-3, np.inf))


def test_sweep_kernels_on_axis_parallel_rays_and_finite_t_max(cuda, scene_json, c6):
    """Axis-parallel rays (1/rd = inf on two axes) through scene.json's
    bunny and C6's grid, and a finite t_max that cuts some hits: K5 and
    K6 equal their plain versions."""
    r = np.random.RandomState(7)
    for tr, lo, hi, k6 in ((scene_json.scene.triangles, [250, 30, 140], [360, 190, 270], False),
                           (c6[0].triangles, [-0.6, 0.03, -0.6], [0.6, 0.2, 0.6], True)):
        tr = tr.to(cuda)
        n = 4099
        ro = r.uniform(lo, hi, (n, 3)).astype(np.float32)
        axis = r.randint(0, 3, n)
        rd = np.zeros((n, 3), np.float32)
        rd[np.arange(n), axis] = np.where(r.rand(n) < 0.5, -1.0, 1.0)
        ro[np.arange(n), axis] = np.where(rd[np.arange(n), axis] > 0, np.asarray(lo)[axis] - 1.0,
                                          np.asarray(hi)[axis] + 1.0)
        ro, rd = torch.from_numpy(ro).to(cuda), torch.from_numpy(rd).to(cuda)
        full = ct.triangle_sweep_plain(tr.sw_table, tr.sw_origin, ro, rd, 1e-3, np.inf)
        assert full[2].float().mean() > 0.05
        t_max = float(full[0][full[2]].median())
        for limit in (np.inf, t_max):
            want = ct.triangle_sweep_plain(tr.sw_table, tr.sw_origin, ro, rd, 1e-3, limit)
            if k6:
                got = ct.cluster_sweep_cuda(tr.sw_table, tr.sw_aabb, tr.sw_origin, ro, rd, 1e-3,
                                            limit)
                _assert_same_winners(got, ct.cluster_sweep_plain(tr, ro, rd, 1e-3, limit))
            else:
                got = _k5(tr, ro, rd, limit)
            _assert_same_winners(got, want)
        assert int(want[2].sum()) < int(full[2].sum())


def test_triangle_kernel_refuses_bad_inputs(cuda, scene_json):
    tr = scene_json.scene.triangles.to(cuda)
    tri, aabb = tr.sw_table, tr.sw_aabb
    ro, rd = _bunny_rays(100, 2, cuda)
    with pytest.raises(ValueError, match="contiguous"):
        ct.triangle_sweep_cuda(tri, aabb, tr.sw_origin, ro.t().contiguous().t(), rd, 1e-3, np.inf)
    with pytest.raises(ValueError, match="is on"):
        ct.triangle_sweep_cuda(tri.cpu(), aabb, tr.sw_origin, ro, rd, 1e-3, np.inf)
    with pytest.raises(ValueError, match="shape"):
        ct.triangle_sweep_cuda(tri[:, :15].contiguous(), aabb, tr.sw_origin, ro, rd, 1e-3, np.inf)
    with pytest.raises(ValueError, match="shape"):
        ct.triangle_sweep_cuda(tri, aabb[1:].contiguous(), tr.sw_origin, ro, rd, 1e-3, np.inf)
    with pytest.raises(TypeError, match="float32"):
        ct.triangle_sweep_cuda(tri, aabb, tr.sw_origin, ro.double(), rd, 1e-3, np.inf)
    before = ct.LAUNCHES
    empty = torch.zeros((0, 3), device=cuda)
    out = ct.triangle_sweep_cuda(tri, aabb, tr.sw_origin, empty, empty, 1e-3, np.inf)
    assert all(x.numel() == 0 for x in out) and ct.LAUNCHES == before


def test_scene_json_render_on_card(cuda, scene_json):
    """scene.json at 64x64 depth 8 on the card: K3 and K5 launched,
    finite, compacted equal to dense, deterministic; the depth-1 image
    equals the CPU's."""
    param = prt.RendererParam(64, 64, max_depth=8)
    compact = prt.Renderer(param, scene_json.camera, scene_json.scene, device=cuda)
    before = (ci.TF_LAUNCHES, ct.LAUNCHES)
    img = compact.render(4)
    assert ci.TF_LAUNCHES > before[0] and ct.LAUNCHES > before[1]
    assert img.device.type == "cuda" and torch.isfinite(img).all() and (img >= 0).all()
    assert torch.equal(img, dense_pass(compact, 4)[0])
    assert torch.equal(img, compact.render(4))
    one = prt.RendererParam(32, 32, max_depth=1)
    on_card = prt.Renderer(one, scene_json.camera, scene_json.scene, device=cuda).render(4).cpu()
    on_cpu = prt.Renderer(one, scene_json.camera, scene_json.scene, device="cpu").render(4)
    assert torch.equal(on_card, on_cpu)


@pytest.fixture(scope="module")
def c6():
    return scenes.bunny_grid()


@pytest.fixture(scope="module")
def motion():
    return scenes.motion_blur()


def _grid_rays(n, seed, device):
    """Rays from around C6's camera aimed at random points of the grid's
    box."""
    r = np.random.RandomState(seed)
    ro = np.array([-0.7, 0.8, 1.2]) + r.uniform(-0.2, 0.2, (n, 3))
    rd = r.uniform([-0.5, 0.03, -0.5], [0.5, 0.19, 0.5], (n, 3)) - ro
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    return (torch.from_numpy(ro.astype(np.float32)).to(device),
            torch.from_numpy(rd.astype(np.float32)).to(device))


def _copies_rays(n, seed, device):
    """tests/test_pallas_triangles.py:_rays, spread over the 27-copy grid:
    origins above it, directions down at it."""
    r = np.random.RandomState(seed)
    ro = r.uniform([-0.9, 0.6, -0.9], [0.9, 0.8, 0.9], (n, 3))
    rd = r.uniform([-0.9, 0.0, -0.9], [0.9, 0.15, 0.9], (n, 3)) - ro
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    return (torch.from_numpy(ro.astype(np.float32)).to(device),
            torch.from_numpy(rd.astype(np.float32)).to(device))


def _check_cluster_kernel(tr, ro, rd):
    """K6 against cluster_sweep_plain, found and idx equal, t bit-equal on
    hits; the stats: some clusters listed, no more swept than listed, no
    more pairs than 32 per sweep."""
    before = (ct.LAUNCHES, ct.CL_LAUNCHES)
    stats = torch.zeros(3, dtype=torch.int32, device=ro.device)
    got = ct.cluster_sweep_cuda(tr.sw_table, tr.sw_aabb, tr.sw_origin, ro, rd, 1e-3, np.inf,
                                stats)
    torch.cuda.synchronize()
    assert (ct.LAUNCHES, ct.CL_LAUNCHES) == (before[0], before[1] + 1)
    _assert_same_winners(got, ct.cluster_sweep_plain(tr, ro, rd, 1e-3, np.inf))
    warps = -(-ro.shape[0] // ct.WARP_RAYS)
    listed, sweeps, pairs = (int(x) for x in stats)
    assert 0 < listed < warps * tr.sw_aabb.shape[0], "the cull skips some clusters"
    assert 0 < sweeps <= listed and sweeps <= pairs <= ct.WARP_RAYS * sweeps
    return got


def test_cluster_kernel_matches_plain_on_card(cuda, c6):
    """K6 against cluster_sweep_plain on C6 (79,488 triangles, 621
    clusters of 128): found and idx equal, t bit-equal on hits, on camera
    rays, rays aimed at the grid (with a ragged tail) and secondary rays
    from the camera rays' mesh hits; on the secondary rays also against
    the dense plain version."""
    scene, cam, _ = c6
    tr = scene.triangles.to(cuda)
    ro, rd, _, _ = camera_rays(Camera.build(cam, 1.0).to(cuda), rng.key(3), 128, 128)
    ro, rd = ro.contiguous(), rd.contiguous()
    secondary = _secondary(tr, ro, rd)
    for rays in ((ro, rd), _grid_rays(5003, 1, cuda), secondary):
        found = _check_cluster_kernel(tr, *rays)[2]
        assert found.float().mean() > 0.05
    _assert_same_winners(_check_cluster_kernel(tr, *secondary),
                         ct.triangle_sweep_plain(tr.sw_table, tr.sw_origin, *secondary, 1e-3,
                                                 np.inf))


def test_cluster_kernel_past_1024_clusters(cuda):
    """K7's case, the same kernel: 27 bunnies, 134,136 triangles, 1,048
    clusters of 128 (three pages of the per-warp list)."""
    tr = scenes.bunny_copies(27).triangles.to(cuda)
    assert tr.sw_aabb.shape[0] > 1024
    found = _check_cluster_kernel(tr, *_copies_rays(4099, 2, cuda))[2]
    assert found.float().mean() > 0.05


def test_cluster_kernel_refuses_bad_inputs(cuda, c6):
    tr = c6[0].triangles.to(cuda)
    tri, aabb = tr.sw_table, tr.sw_aabb
    ro, rd = _grid_rays(100, 2, cuda)
    with pytest.raises(ValueError, match="contiguous"):
        ct.cluster_sweep_cuda(tri, aabb, tr.sw_origin, ro.t().contiguous().t(), rd, 1e-3, np.inf)
    with pytest.raises(ValueError, match="shape"):
        ct.cluster_sweep_cuda(tri, aabb[:-1].contiguous(), tr.sw_origin, ro, rd, 1e-3, np.inf)
    with pytest.raises(TypeError, match="float32"):
        ct.cluster_sweep_cuda(tri, aabb, tr.sw_origin, ro.double(), rd, 1e-3, np.inf)
    before = ct.CL_LAUNCHES
    empty = torch.zeros((0, 3), device=cuda)
    out = ct.cluster_sweep_cuda(tri, aabb, tr.sw_origin, empty, empty, 1e-3, np.inf)
    assert all(x.numel() == 0 for x in out) and ct.CL_LAUNCHES == before


def test_motion_kernel_matches_plain_on_card(cuda, motion):
    """K4 (a moving sphere table, (S, 7)) against phase_a_plain with the
    rays' shutter times: kind and idx equal, t bit-equal, winners
    on the moving spheres; without t_ray both test time 0."""
    scene, cam, _ = motion
    tables = scene.to(cuda).phase_a
    assert tables.sph_motion
    ro, rd, _, _ = camera_rays(Camera.build(cam, 1.0).to(cuda), rng.key(3), 128, 128)
    r = np.random.RandomState(0)
    iro = r.uniform([-3, 0.1, -3], [3, 2.5, 3], (5000, 3))
    ird = r.uniform([-1.5, 0.2, -0.5], [2.5, 0.7, 0.5], (5000, 3)) - iro
    ird /= np.linalg.norm(ird, axis=1, keepdims=True)
    sets = [(ro.contiguous(), rd.contiguous()),
            tuple(torch.from_numpy(x.astype(np.float32)).to(cuda) for x in (iro, ird))]
    for ro, rd in sets:
        t_ray = torch.from_numpy(r.uniform(0, 1, ro.shape[0]).astype(np.float32)).to(cuda)
        for times in (t_ray, None):
            before = (ci.LAUNCHES, ci.TF_LAUNCHES, ci.MOTION_LAUNCHES)
            got = ci.phase_a_cuda(tables, ro, rd, 1e-3, np.inf, times)
            torch.cuda.synchronize()
            assert (ci.LAUNCHES, ci.TF_LAUNCHES, ci.MOTION_LAUNCHES) == (
                before[0], before[1], before[2] + 1)
            _assert_phase_a_equal(got, ci.phase_a_plain(tables, ro, rd, 1e-3, np.inf, times))
            assert int(((got[1] == 0) & (got[2] > 0)).sum()) > 0


def _scene_render_on_card(cuda, scene, cam, counts, launched, idle):
    """64x64 depth 8 on the card: the path's kernel launched and the other
    not, finite, compacted equal to dense, deterministic; the depth-1
    image equals the CPU's."""
    param = prt.RendererParam(64, 64, max_depth=8)
    compact = prt.Renderer(param, cam, scene, device=cuda)
    before = counts()
    img = compact.render(4)
    after = counts()
    assert after[launched] > before[launched] and after[idle] == before[idle]
    assert img.device.type == "cuda" and torch.isfinite(img).all() and (img >= 0).all()
    assert torch.equal(img, dense_pass(compact, 4)[0])
    assert torch.equal(img, compact.render(4))
    one = prt.RendererParam(32, 32, max_depth=1)
    on_card = prt.Renderer(one, cam, scene, device=cuda).render(4).cpu()
    on_cpu = prt.Renderer(one, cam, scene, device="cpu").render(4)
    assert torch.equal(on_card, on_cpu)


def test_c6_render_on_card(cuda, c6):
    """C6: K6 launched, K5 not."""
    scene, cam, _ = c6
    _scene_render_on_card(cuda, scene, cam, lambda: (ct.CL_LAUNCHES, ct.LAUNCHES), 0, 1)


def test_c6_default_tile_equals_tiles_of_65536(cuda, c6):
    """C6 at its 512x512, depth 3: the card's default tile, the whole
    wavefront of 262,144 rays in one, renders the image that tiles of
    65,536 render, bit for bit (compaction is per tile and equals the
    dense loop)."""
    scene, cam, _ = c6
    param = prt.RendererParam(512, 512, max_depth=3)
    one = prt.Renderer(param, cam, scene, device=cuda)
    tiled = prt.Renderer(param, cam, scene, device=cuda, tile_size=65536)
    assert one.tile_size == 512 * 512
    assert torch.equal(one.render(3), tiled.render(3))


def test_zy_train_step_default_tile_matches_tiles_of_65536(cuda, zy, monkeypatch):
    """zy at its 800x800, depth 3: the direct train step at the card's
    default tile (the 640,000 rays in one tile, one tangent batch per
    active row) against the same step with tiles of 65,536 (ten), from
    the same state under the same key: the loss within the train cell's
    loss_gap (2e-4), each leaf's gradient, read from the update as the
    benchmark reads it, within its grad_gap (1.5e-2: the gap between the
    norms over the larger of the leaf's and the median leaf's)."""
    from ray_tracing_tpu_torch.parallel import mesh as pm
    from ray_tracing_tpu_torch.render import prb_scalar
    from ray_tracing_tpu_torch.render.prb_scalar import AllParams

    lr, size = 0.01, 800
    scene = zy.scene.to(cuda)
    camera = Camera.build(zy.camera, 1.0).to(cuda)
    step = pm.make_prb_train_step_all_direct(camera, scene, width=size, height=size,
                                             max_depth=3, mesh=pm.make_mesh(cuda), lr=lr)
    params = params_of(scene)
    target = torch.full((size, size, 3), 0.25, device=cuda)
    tiles, traced, tiled = [], prb_scalar._tile_grads, pm.tiled_loss_and_grad

    def counted(*args, **kw):
        tiles[-1] += 1
        return traced(*args, **kw)

    monkeypatch.setattr(prb_scalar, "_tile_grads", counted)
    out = {}
    for tile in (None, 65536):
        monkeypatch.setattr(pm, "tiled_loss_and_grad",
                            lambda *a, _t=tile, **kw: tiled(*a, **dict(kw, tile_size=_t)))
        tiles.append(0)
        new, loss = step(params, scene, rng.key(2), target)
        out[tile] = float(loss), [float(((p.double() - q.double()) / lr).norm())
                                  for p, q in zip(params, new)]
    assert tiles == [1, 10]
    (loss_1, norms_1), (loss_10, norms_10) = out[None], out[65536]
    assert abs(loss_1 - loss_10) <= 2e-4 * abs(loss_10)
    median = float(np.median(norms_10))
    assert norms_10[0] > 0 and median > 0
    for name, a, b in zip(AllParams._fields, norms_1, norms_10):
        assert abs(a - b) <= 1.5e-2 * max(b, median), (name, a, b)


def _eager_replay(scene, ro, rd, key, depth, g, touched):
    """(gfuzz, gir) of one eager replay of the touched rays at their own
    widths (integrator.trace_subset_dot without graphs, the host key)."""
    from ray_tracing_tpu_torch.render.integrator import trace_subset_dot
    from ray_tracing_tpu_torch.render.prb_scalar import _active_rows, _with_all

    p = params_of(scene)
    rows = _active_rows(scene)
    sub = torch.nonzero((touched & 3) != 0).squeeze(1)
    leaves = [p.fuzz[rows[0]].requires_grad_(True), p.ir[rows[1]].requires_grad_(True)]
    s = _with_all(scene, p._replace(fuzz=p.fuzz.index_copy(0, rows[0], leaves[0]),
                                    ir=p.ir.index_copy(0, rows[1], leaves[1])))
    val = trace_subset_dot(s, ro[sub], rd[sub], key, depth, g[sub],
                           torch.ones_like(sub, dtype=torch.bool), sub)
    out = [torch.zeros_like(p.fuzz), torch.zeros_like(p.ir)]
    for o, r, grad in zip(out, rows, torch.autograd.grad(val, leaves)):
        o[r] = grad
    return tuple(out)


def test_replay_graphs_on_card(cuda, zy):
    """zy at 128x128, depth 20 (three stages): the fuzz / IR pass with its
    stages as CUDA graphs (render/stage_graphs.py) against the eager
    replay within rtol 1e-5, atol 2e-6; after a first step, which
    captures each stage's width, a second step in the same buckets
    captures nothing, replays 3 stages and repeats the first step's
    gradients bit for bit; a geometry tensor
    that is another tensor (same values) is captured anew, with the same
    gradients."""
    import dataclasses

    from ray_tracing_tpu_torch.render.prb_scalar import scalar_tangent_pass
    from ray_tracing_tpu_torch.render.prb_tape import trace_taped
    from ray_tracing_tpu_torch.render.stage_graphs import replay_graphs

    size, depth = 128, 20
    scene = zy.scene.to(cuda)
    ro, rd, _, key = camera_rays(Camera.build(zy.camera, 1.0).to(cuda), rng.key(19), size, size)
    g = torch.from_numpy(np.random.RandomState(20).uniform(0.5, 1.5, (size * size, 3))
                         .astype(np.float32)).to(cuda)
    _, touched, _ = trace_taped(scene, ro, rd, key, depth)
    graphs = replay_graphs(scene, cuda)

    def step(s):
        return scalar_tangent_pass(params_of(s), s, ro, rd, key, depth, g, touched)

    steps = [step(scene)]
    captures, replays = graphs.captures, graphs.replays
    steps.append(step(scene))
    assert (graphs.captures, graphs.replays) == (captures, replays + 3)
    want = _eager_replay(scene, ro, rd, key, depth, g, touched)
    for name, a, b, c in zip(("fuzz", "ir"), steps[0], steps[1], want):
        assert torch.equal(a, b), name
        assert (c != 0).any(), name
        np.testing.assert_allclose(b.cpu().numpy(), c.cpu().numpy(), rtol=1e-5, atol=2e-6,
                                   err_msg=name)
    moved = dataclasses.replace(scene, spheres=dataclasses.replace(
        scene.spheres, center=scene.spheres.center.clone()))
    captures = graphs.captures
    again = step(moved)
    assert graphs.captures == captures + 3
    for a, b in zip(again, steps[1]):
        assert torch.equal(a, b)


def test_replay_launch_counts_match_the_profiler_on_card(cuda, zy):
    """Two steps of zy at 128x128, depth 20 (the taped forward, then the
    fuzz / IR pass with its stages as CUDA graphs), the first capturing
    every stage anew: each hand-written kernel's wrapper counts the
    launches the profiler sees, a replay the kernels its graphs hold and
    a capture none (benchmark/harness/profile.py reads both)."""
    import dataclasses
    import importlib.util

    from ray_tracing_tpu_torch.render.prb_scalar import scalar_tangent_pass
    from ray_tracing_tpu_torch.render.prb_tape import trace_taped
    from ray_tracing_tpu_torch.render.stage_graphs import replay_graphs

    spec = importlib.util.spec_from_file_location("harness_profile",
                                                  "benchmark/harness/profile.py")
    harness = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(harness)
    size, depth = 128, 20
    scene = zy.scene.to(cuda)
    scene = dataclasses.replace(scene, spheres=dataclasses.replace(
        scene.spheres, center=scene.spheres.center.clone()))  # not captured before
    ro, rd, _, key = camera_rays(Camera.build(zy.camera, 1.0).to(cuda), rng.key(19), size, size)
    g = torch.from_numpy(np.random.RandomState(20).uniform(0.5, 1.5, (size * size, 3))
                         .astype(np.float32)).to(cuda)
    graphs = replay_graphs(scene, cuda)
    captures, replays = graphs.captures, graphs.replays

    def steps():
        for _ in range(2):
            _, touched, _ = trace_taped(scene, ro, rd, key, depth)
            scalar_tangent_pass(params_of(scene), scene, ro, rd, key, depth, g, touched)

    _, trace = harness.profile(steps, torch.cuda.synchronize)
    assert graphs.captures - captures == 3 and graphs.replays - replays == 6
    assert trace.family_seen("K1") > 0
    assert trace.launch_check() == []


def _moving_spheres(device):
    """A fuzzy metal sphere and a glass sphere in motion over a Perlin
    floor under an important light, and its camera, shutter [0, 1]."""
    b = prt.SceneBuilder(background=(0.05, 0.05, 0.05))
    floor = b.add_lambertian(b.add_texture_noise(0.7, 4))
    light = b.add_diffuse_light(b.add_texture_solid((4.0, 3.5, 3.0)))
    metal = b.add_metal((0.9, 0.85, 0.8), 0.2)
    glass = b.add_dielectric(1.5)
    b.add_rect("zx", -2, 2, -2, 2, 0.0, floor, positive=True)
    b.add_rect("zx", -1, 1, -1, 1, 3.0, light, positive=False, important=True)
    b.add_sphere_moving((-0.8, 0.5, -0.8), (-0.5, 0.5, -0.8), 0.4, metal)
    b.add_sphere_moving((0.8, 0.5, -0.8), (0.8, 0.7, -0.8), 0.4, glass)
    camera = Camera.build(prt.CameraParam((0.0, 1.2, 1.8), (0.0, 0.5, -0.8), 60, time0=0.0,
                                          time1=1.0), 1.0)
    return b.build().to(device), camera.to(device)


def test_replay_graphs_motion_scene_on_card(cuda):
    """Moving spheres, whose shutter window each step stamps anew
    (models/camera.py:stamp_shutter, another tensor of the same values):
    the graphed fuzz / IR pass captures its stages at the first step
    only and replays them at the second, with the first step's
    gradients bit for bit; both match the eager replay within rtol 1e-5,
    atol 2e-6."""
    from ray_tracing_tpu_torch.models.camera import stamp_shutter
    from ray_tracing_tpu_torch.render.prb_scalar import scalar_tangent_pass
    from ray_tracing_tpu_torch.render.prb_tape import trace_taped
    from ray_tracing_tpu_torch.render.stage_graphs import replay_graphs

    size, depth = 128, 8
    scene, camera = _moving_spheres(cuda)
    ro, rd, _, key = camera_rays(camera, rng.key(22), size, size)
    g = torch.from_numpy(np.random.RandomState(23).uniform(0.5, 1.5, (size * size, 3))
                         .astype(np.float32)).to(cuda)
    graphs = replay_graphs(scene, cuda)
    steps, captured, replayed = [], [], []
    for _ in range(2):
        s = stamp_shutter(scene, camera)
        _, touched, _ = trace_taped(s, ro, rd, key, depth)
        captures, replays = graphs.captures, graphs.replays
        steps.append(scalar_tangent_pass(params_of(s), s, ro, rd, key, depth, g, touched))
        captured.append(graphs.captures - captures)
        replayed.append(graphs.replays - replays)
    assert captured[0] == replayed[0] > 0
    assert (captured[1], replayed[1]) == (0, replayed[0])
    want = _eager_replay(s, ro, rd, key, depth, g, touched)
    for name, a, b, c in zip(("fuzz", "ir"), steps[0], steps[1], want):
        assert torch.equal(a, b), name
        assert (c != 0).any(), name
        np.testing.assert_allclose(b.cpu().numpy(), c.cpu().numpy(), rtol=1e-5, atol=2e-6,
                                   err_msg=name)


def test_motion_render_on_card(cuda, motion):
    """The motion scene: K4 launched, K1 not."""
    scene, cam, _ = motion
    _scene_render_on_card(cuda, scene, cam, lambda: (ci.MOTION_LAUNCHES, ci.LAUNCHES), 0, 1)


def _without(scene, prefixes):
    """``scene`` with the triangle-table fields named by ``prefixes`` dropped."""
    import dataclasses

    tr = scene.triangles
    return dataclasses.replace(scene, triangles=dataclasses.replace(tr, **{
        f.name: None for f in dataclasses.fields(tr) if f.name.startswith(prefixes)}))


def test_sweep_tail_runs_k5_over_the_whole_table(cuda):
    """Seven bunnies (34,776 triangles, above SWEEP_MAX_TRIS) without
    cluster tables take "sweep": K5 over the whole table, equal to the
    dense plain version (found and idx equal, t bit-equal), and a render
    launches K5 and not K6."""
    from ray_tracing_tpu_torch.ops.intersect import mesh_strategy

    tail = _without(scenes.bunny_copies(7), ("cl_",))
    assert mesh_strategy(tail) == "sweep"
    tr = tail.to(cuda).triangles
    r = np.random.RandomState(12)
    ro = r.uniform([-0.9, 0.6, -0.9], [0.9, 0.8, 0.9], (20000, 3))
    rd = r.uniform([-0.9, 0.0, -0.9], [0.9, 0.15, 0.9], (20000, 3)) - ro
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    ro, rd = (torch.from_numpy(x.astype(np.float32)).to(cuda) for x in (ro, rd))
    t, idx, found = ct.triangle_sweep_cuda(tr.sw_table, tr.sw_aabb, tr.sw_origin, ro, rd, 1e-3,
                                           float("inf"))
    pt, pidx, pfound = ct.triangle_sweep_plain(tr.sw_table, tr.sw_origin, ro, rd, 1e-3,
                                               float("inf"))
    assert float(found.float().mean()) > 0.01
    assert torch.equal(found, pfound) and torch.equal(idx[found], pidx[found])
    assert torch.equal(t[found], pt[found])
    cam = prt.CameraParam(look_from=(0.0, 0.55, 0.9), look_at=(0.0, 0.08, -0.6), vfov=60)
    k5, k6 = ct.LAUNCHES, ct.CL_LAUNCHES
    img = prt.Renderer(prt.RendererParam(64, 64, max_depth=3), cam, tail, device="cuda").render(0)
    assert bool(torch.isfinite(img).all())
    assert ct.LAUNCHES > k5 and ct.CL_LAUNCHES == k6


def test_brute_tail_matches_k5_on_card(cuda):
    """C4's bunny without sweep constants takes "brute" (plain PyTorch on
    the card): its winners equal K5's on the full table (kind equal, t to
    rtol 1e-5, the triangle equal where t is not tied), no sweep
    launched."""
    from ray_tracing_tpu_torch.ops.intersect import KIND_TRIANGLE, intersect_scene, mesh_strategy

    scene, cam, _ = scenes.bunny()
    brute = _without(scene, ("cl_", "sw_"))
    assert mesh_strategy(brute) == "brute"
    ro, rd, _, _ = camera_rays(Camera.build(cam, 1.0).to(cuda), rng.key(0), 64, 64)
    k5, k6 = ct.LAUNCHES, ct.CL_LAUNCHES
    got = intersect_scene(brute.to(cuda), ro, rd, prt.EPSILON, float("inf"))
    assert ct.LAUNCHES == k5 and ct.CL_LAUNCHES == k6
    want = intersect_scene(scene.to(cuda), ro, rd, prt.EPSILON, float("inf"))
    tri = want.kind == KIND_TRIANGLE
    assert torch.equal(got.kind, want.kind) and bool(tri.any())
    rel = (got.t - want.t).abs() / want.t
    assert float(rel[tri].max()) <= 1e-5
    assert bool((rel[tri & (got.index != want.index)] <= 2e-5).all())


def test_multicard_on_every_card(cuda):
    """multicard_torch.py with one NCCL rank on each card present (zy at
    256^2, depth 2): exit 0 (every rank's own checks held), one record
    per rank, each rank loaded the kernels without building them and its
    direct step launched K1 and K2."""
    import json
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    run = subprocess.run([sys.executable, "multicard_torch.py", "--size", "256", "--depth", "2"],
                         cwd=root, capture_output=True, text=True, timeout=600)
    assert run.returncode == 0, run.stderr[-3000:]
    rec = json.loads(run.stdout.splitlines()[-1])
    assert rec["ranks"] == torch.cuda.device_count() and rec["backend"] == "nccl"
    for r in rec["per_rank"]:
        assert r["device"] == f"cuda:{r['rank']}" and r["compiles"] == 0
        assert r["launches"]["k1"] > 0 and r["launches"]["k2"] > 0
        assert r["k1"]["err"] == 0.0 and r["k2"]["err"] == 0.0
