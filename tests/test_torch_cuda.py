"""Tests of the port that need an NVIDIA GPU: K1 against its plain
version on the card, and the render path on the card.  They skip
without a GPU.  The file imports no JAX, so on a machine with a GPU
and without JAX it runs on its own:

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

import ray_tracing_tpu_torch as prt
from ray_tracing_tpu_torch.models.camera import Camera, camera_rays
from ray_tracing_tpu_torch.ops import cuda_intersect as ci
from ray_tracing_tpu_torch.ops import rng

pytestmark = pytest.mark.cuda

ZY = "data/zy_scene.json"


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (K1 has no CPU mode)")
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
