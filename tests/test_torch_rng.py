"""The port's counter-hash RNG and key derivation against the JAX
package's: every word must be bit-equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tracing_tpu.ops import rng as jrng
from ray_tracing_tpu_torch.ops import rng

torch.set_num_threads(2)


def test_pcg_bit_equal():
    words = np.random.RandomState(0).randint(0, 2**32, size=4096, dtype=np.uint64)
    words = np.concatenate([words, [0, 1, 2**31 - 1, 2**31, 2**32 - 1]]).astype(np.uint32)
    ours = rng.pcg(torch.from_numpy(words.astype(np.int64))).numpy()
    ref = np.asarray(jrng.pcg(jnp.asarray(words)))
    np.testing.assert_array_equal(ours, ref.astype(np.int64))


@pytest.mark.parametrize("seed", [0, 1, 42, 2**31 - 1, -1, -(2**31)])
def test_key_and_split_match_jax(seed):
    k = jax.random.key(seed)
    np.testing.assert_array_equal(rng.key(seed), np.asarray(jax.random.key_data(k)))
    for num in (2, 3, 7):
        np.testing.assert_array_equal(
            rng.split(rng.key(seed), num),
            np.asarray(jax.random.key_data(jax.random.split(k, num))),
        )
    # a split of a split: the camera's subkeys of a derived key
    k2 = jax.random.split(k)[1]
    np.testing.assert_array_equal(
        rng.split(rng.split(rng.key(seed))[1]),
        np.asarray(jax.random.key_data(jax.random.split(k2))),
    )


def test_key_rejects_seed_beyond_32_bits():
    with pytest.raises(ValueError):
        rng.key(2**31)


@pytest.mark.parametrize("case", range(4))
def test_ray_uniforms_bit_equal(case):
    r = np.random.RandomState(100 + case)
    seed = int(r.randint(0, 2**31))
    stream = int(r.choice([0, 1, 19, rng.M32 // 3, jrng.TIME_STREAM]))
    n_cols = int(r.choice([1, 5, 12]))
    ids = r.randint(0, 2**32, size=2048, dtype=np.uint64).astype(np.uint32)
    ids[:4] = [0, 2**31 - 1, 2**31, 2**32 - 1]  # ids >= 2**31 included
    ours = rng.ray_uniforms(rng.key(seed), torch.from_numpy(ids.astype(np.int64)), stream, n_cols)
    ref = jrng.ray_uniforms(jax.random.key(seed), jnp.asarray(ids), stream, n_cols)
    assert ours.dtype == torch.float32
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
