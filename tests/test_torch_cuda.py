"""Tests of the port that need an NVIDIA GPU: K1 and K2 against their
plain versions on the card, and the render and gradient paths on the
card.  They skip without a GPU.  The file imports no JAX, so on a machine with a GPU
and without JAX it runs on its own:

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

import ray_tracing_tpu_torch as prt
from ray_tracing_tpu_torch.models.camera import Camera, camera_rays
from ray_tracing_tpu_torch.ops import _build
from ray_tracing_tpu_torch.ops import cuda_intersect as ci
from ray_tracing_tpu_torch.ops import cuda_scatter as cs
from ray_tracing_tpu_torch.ops import rng
from ray_tracing_tpu_torch.render.prb_scalar import params_of, prb_loss_and_grad_all

pytestmark = pytest.mark.cuda

ZY = "data/zy_scene.json"


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (K1 and K2 have no CPU mode)")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def zy():
    return prt.load_scene_json(ZY)


def _ray_sets(bundle, device):
    ro, rd, _, _ = camera_rays(Camera.build(bundle.camera, 1.0).to(device), rng.key(3), 128, 128)
    r = np.random.RandomState(0)
    iro = r.uniform(1.0, 554.0, (5000, 3)).astype(np.float32)  # ragged tail
    ird = r.normal(size=(5000, 3)).astype(np.float32)
    ird /= np.linalg.norm(ird, axis=1, keepdims=True)
    return [(ro, rd), (torch.from_numpy(iro).to(device), torch.from_numpy(ird).to(device))]


def test_kernel_matches_plain_on_card(cuda, zy):
    sph, rect = ci.pack_primitive_tables(zy.scene.to(cuda))
    for ro, rd in _ray_sets(zy, cuda):
        before = ci.LAUNCHES
        got = ci.phase_a_cuda(sph, rect, ro, rd, 1e-3, np.inf)
        torch.cuda.synchronize()
        assert ci.LAUNCHES == before + 1
        want = ci.phase_a_plain(sph, rect, ro, rd, 1e-3, np.inf)
        assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
        torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=0.0)


def test_kernel_refuses_bad_inputs(cuda, zy):
    sph, rect = ci.pack_primitive_tables(zy.scene.to(cuda))
    ro, rd = _ray_sets(zy, cuda)[1]
    with pytest.raises(ValueError, match="contiguous"):
        ci.phase_a_cuda(sph, rect, ro.t().contiguous().t(), rd, 1e-3, np.inf)
    with pytest.raises(ValueError, match="is on"):
        ci.phase_a_cuda(sph.cpu(), rect, ro, rd, 1e-3, np.inf)
    with pytest.raises(TypeError, match="float32"):
        ci.phase_a_cuda(sph, rect, ro.double(), rd, 1e-3, np.inf)
    empty = torch.zeros((0, 3), device=cuda)
    before = ci.LAUNCHES
    assert all(x.numel() == 0 for x in ci.phase_a_cuda(sph, rect, empty, empty, 1e-3, np.inf))
    assert ci.LAUNCHES == before


def test_render_on_card(cuda, zy):
    param = prt.RendererParam(96, 96, max_depth=10)
    compact = prt.Renderer(param, zy.camera, zy.scene, device=cuda)
    dense = prt.Renderer(param, zy.camera, zy.scene, device=cuda, compaction=False)
    before = ci.LAUNCHES
    img = compact.render(4)
    assert ci.LAUNCHES > before
    assert img.device.type == "cuda" and torch.isfinite(img).all() and (img >= 0).all()
    assert torch.equal(img, dense.render(4))
    assert torch.equal(img, compact.render(4))
    one = prt.RendererParam(96, 96, max_depth=1)
    on_card = prt.Renderer(one, zy.camera, zy.scene, device=cuda).render(4).cpu()
    on_cpu = prt.Renderer(one, zy.camera, zy.scene, device="cpu").render(4)
    assert (on_card == on_cpu).all(dim=-1).float().mean() >= 0.999


def test_both_kernels_build_through_the_shared_builder(cuda):
    libs = [_build.build(source) for source in (ci.SOURCE, cs.SOURCE)]
    assert [lib.name.split("_")[0] for lib in libs] == ["intersect", "scatter"]
    assert all(lib.exists() and lib.parent == _build.BUILD_DIR for lib in libs)


def _scatter_rows(n, p, seed, device):
    r = np.random.RandomState(seed)
    texel = np.where(r.rand(n) < 0.5, r.randint(0, 64, n), r.randint(-1, p, n)).astype(np.int32)
    contrib = r.uniform(0.0, 1.0, (n, 3)).astype(np.float32)
    mask = r.rand(n) < 0.3
    return [torch.from_numpy(x).to(device) for x in (texel, contrib, mask)]


def test_scatter_kernel_matches_plain_on_card(cuda):
    """Heavy duplicates (half the rows on 64 texels), texel -1 rows and a
    ragged row count.  Atomics reorder the sums of duplicates: rtol 1e-5;
    rows without duplicates are bit-equal."""
    p = 4099
    texel, contrib, mask = _scatter_rows(100_003, p, 0, cuda)
    before = cs.LAUNCHES
    got = cs.scatter_add_cuda(torch.zeros((p, 3), device=cuda), texel, contrib, mask)
    torch.cuda.synchronize()
    assert cs.LAUNCHES == before + 1
    want = cs.scatter_add_plain(torch.zeros((p, 3), device=cuda), texel, contrib, mask)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    unique = torch.randperm(p, device=cuda)[:1000].to(torch.int32)
    rows = (unique, contrib[:1000].contiguous(), torch.ones(1000, dtype=torch.bool, device=cuda))
    once = cs.scatter_add(torch.zeros((p, 3), device=cuda), *rows)
    assert torch.equal(once, cs.scatter_add_plain(torch.zeros((p, 3), device=cuda), *rows))


def test_scatter_kernel_refuses_bad_inputs(cuda):
    texel, contrib, mask = _scatter_rows(1000, 64, 1, cuda)
    g = torch.zeros((64, 3), device=cuda)
    with pytest.raises(TypeError, match="int32"):
        cs.scatter_add_cuda(g, texel.long(), contrib, mask)
    with pytest.raises(ValueError, match="contiguous"):
        cs.scatter_add_cuda(g, texel, contrib.t().contiguous().t(), mask)
    with pytest.raises(ValueError, match="is on"):
        cs.scatter_add_cuda(g, texel.cpu(), contrib, mask)
    with pytest.raises(ValueError, match="shape"):
        cs.scatter_add_cuda(g, texel[:10], contrib, mask)
    with pytest.raises(TypeError, match="bool"):
        cs.scatter_add_cuda(g, texel, contrib, mask.to(torch.uint8))
    before = cs.LAUNCHES
    empty = texel[:0], contrib[:0], mask[:0]
    assert cs.scatter_add_cuda(g, *empty) is g and cs.LAUNCHES == before


def test_gradient_pass_on_card_matches_cpu(cuda, zy):
    """zy at 96x96 depth 6: the loss and the color-linear gradients
    (color, images -- the leaf K2 writes --, metal_albedo) on the card
    against the port's CPU run at the same key, and K2 launched on the
    card.  A few paths part where the card's and the CPU's
    transcendentals round differently, so each quantity is held to the
    card's own noise floor: its difference to the CPU at the same key is
    at most 0.6x its difference between two keys."""
    cam = Camera.build(zy.camera, 1.0)
    leaves = ("color", "images", "metal_albedo")

    def run(device, seed):
        scene = zy.scene.to(device)
        ro, rd, _, k_trace = camera_rays(cam.to(device), rng.key(seed), 96, 96)
        before = cs.LAUNCHES
        loss, grads = prb_loss_and_grad_all(torch.mean, params_of(scene), scene, ro, rd,
                                            k_trace, 6)
        assert all(torch.isfinite(g).all() for g in grads)
        return ([loss.cpu()] + [getattr(grads, f).cpu() for f in leaves],
                cs.LAUNCHES - before)

    on_cpu, k_cpu = run("cpu", 4)
    on_card, k_card = run(cuda, 4)
    other, _ = run(cuda, 5)
    assert k_cpu == 0 and k_card > 0
    for name, a, b, c in zip(("loss",) + leaves, on_card, on_cpu, other):
        matched = float((a - b).abs().sum())
        floor = float((a - c).abs().sum())
        assert floor > 0 and matched <= 0.6 * floor, (name, matched, floor)
