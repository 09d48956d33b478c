"""K2's plain version, ``scatter_add_plain``, against the JAX package's
scatter-add (``scatter_add_planar`` in interpret mode, then
``from_planar``) on the same seeded rows, and the shared kernel build."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tracing_tpu.ops.pallas_scatter import from_planar, planar_rows, scatter_add_planar
from ray_tracing_tpu_torch.ops import _build
from ray_tracing_tpu_torch.ops import cuda_scatter as cs

TOL = dict(rtol=1e-6, atol=1e-7)  # the JAX package's own (test_pallas_scatter.py)


def _both(p, texel, contrib, mask, base=None):
    """(port table, JAX table) after scattering the same rows into the
    same (P, 3) starting table."""
    base = np.zeros((p, 3), np.float32) if base is None else base
    ours = cs.scatter_add(torch.from_numpy(base.copy()), [(torch.from_numpy(texel),
                          torch.from_numpy(contrib), torch.from_numpy(mask))])
    g0 = jnp.asarray(base).T.reshape(3, -1)
    g0 = jnp.pad(g0, ((0, 0), (0, planar_rows(p) * 128 - p))).reshape(3, -1, 128)
    theirs = from_planar(scatter_add_planar(g0, jnp.asarray(texel), jnp.asarray(contrib),
                                            jnp.asarray(mask), interpret=True), p)
    return ours.numpy(), np.asarray(theirs)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("p", [257, 4096])
def test_plain_matches_jax(seed, p):
    """Random rows with heavy duplicates (700 rows over p texels, half
    masked) into a nonzero table."""
    r = np.random.RandomState(seed)
    n = 700
    texel = r.randint(0, p, n).astype(np.int32)
    contrib = r.uniform(-1, 1, (n, 3)).astype(np.float32)
    mask = r.rand(n) < 0.5
    base = r.uniform(0, 1, (p, 3)).astype(np.float32)
    ours, theirs = _both(p, texel, contrib, mask, base)
    np.testing.assert_allclose(ours, theirs, **TOL)


def test_all_masked_is_identity():
    p = 1000
    base = np.random.RandomState(0).rand(p, 3).astype(np.float32)
    texel = np.zeros((64,), np.int32)
    ours, theirs = _both(p, texel, np.ones((64, 3), np.float32), np.zeros((64,), bool), base)
    np.testing.assert_array_equal(ours, base)
    np.testing.assert_array_equal(theirs, base)


def test_negative_texels_are_skipped():
    p = 300
    r = np.random.RandomState(2)
    texel = np.where(r.rand(512) < 0.5, -1, r.randint(0, p, 512)).astype(np.int32)
    contrib = r.uniform(-1, 1, (512, 3)).astype(np.float32)
    ours, theirs = _both(p, texel, contrib, np.ones((512,), bool))
    np.testing.assert_allclose(ours, theirs, **TOL)
    want = np.zeros((p, 3), np.float32)
    np.add.at(want, texel[texel >= 0], contrib[texel >= 0])
    np.testing.assert_allclose(ours, want, **TOL)


def test_duplicates_accumulate():
    n = 1024
    ours, theirs = _both(300, np.full((n,), 42, np.int32), np.ones((n, 3), np.float32),
                         np.ones((n,), bool))
    assert np.all(ours[42] == n) and ours.sum() == 3 * n
    np.testing.assert_array_equal(ours, theirs)


def test_wrapper_takes_plain_version_only_on_cpu():
    g = torch.zeros((4, 3), device="meta")
    t = torch.zeros((2,), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        cs.scatter_add(g, [(t, torch.zeros((2, 3), device="meta"),
                            torch.ones(2, dtype=torch.bool, device="meta"))])
    with pytest.raises(ValueError, match="CUDA tensors"):
        cs.scatter_add_cuda(torch.zeros((4, 3)), [(torch.zeros((2,), dtype=torch.int32),
                                                   torch.zeros((2, 3)),
                                                   torch.ones(2, dtype=torch.bool))])


def test_build_keys_differ_per_source(tmp_path):
    """Each kernel source builds into its own library: different sources
    (or flags) give different keys, the same source the same key."""
    a, b = tmp_path / "a.cu", tmp_path / "b.cu"
    a.write_text("// one\n")
    b.write_text("// two\n")
    assert _build.build_key(a) != _build.build_key(b)
    assert _build.build_key(a) == _build.build_key(a)
    assert _build.build_key(a) != _build.build_key(a, _build.NVCC_FLAGS + ("-G",))
    libs = {_build.library_path(s) for s in (cs.SOURCE, _build.CSRC / "intersect.cu")}
    assert len(libs) == 2 and all(lib.parent == _build.BUILD_DIR for lib in libs)


def _segments(seed, sizes=(3000, 1700, 900), p=257):
    """Seeded segments with duplicates inside and across them (half the
    rows on 16 texels), negative texels and half the rows masked."""
    r = np.random.RandomState(seed)
    out = []
    for n in sizes:
        texel = np.where(r.rand(n) < 0.5, r.randint(0, 16, n), r.randint(-1, p, n))
        out.append((torch.from_numpy(texel.astype(np.int32)),
                    torch.from_numpy(r.uniform(-1, 1, (n, 3)).astype(np.float32)),
                    torch.from_numpy(r.rand(n) < 0.5)))
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_segments_plain_equals_sequential_calls(seed):
    """One call over several segments equals one call per segment in
    order, bit for bit, and both equal a serial float32 loop in row order
    (the order K2 adds in on the card)."""
    p = 257
    segs = _segments(seed, p=p)
    base = torch.from_numpy(np.random.RandomState(9).uniform(0, 1, (p, 3)).astype(np.float32))
    once = cs.scatter_add_plain(base.clone(), segs)
    each = base.clone()
    for seg in segs:
        cs.scatter_add_plain(each, [seg])
    assert torch.equal(once, each)
    want = base.numpy().copy()
    for texel, contrib, mask in segs:
        for t, c, m in zip(texel.numpy(), contrib.numpy(), mask.numpy()):
            if m and t >= 0:
                want[t] = want[t] + c
    np.testing.assert_array_equal(once.numpy(), want)
    assert cs.scatter_add(base.clone(), []).equal(base)
