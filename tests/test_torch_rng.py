"""repro_torch.core.rng against repro.core.rng and jax.random: the
per-vertex hash and the threefry key schedule must match bit for bit."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs in parallel workers, and torch's
# OpenMP threads spinning against them slow every worker several-fold
torch.set_num_threads(1)
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import rng as R  # noqa: E402
from repro_torch.core import rng as T  # noqa: E402

SEEDS = (0, 1, 7, 12345, 2**31 - 1, -5)


def _kd(k):
    return tuple(int(x) for x in np.asarray(jax.random.key_data(k)))


@pytest.mark.parametrize("salt", [0, 1, 123, 0x9E3779B9, 2**32 - 1])
def test_hash_uniform_bit_exact_including_padding(salt):
    rng = np.random.default_rng(salt % 1000)
    ids = rng.integers(-1, 2**31 - 1, size=5000).astype(np.int32)
    ids[:17] = -1                       # padding ids hash as 0xFFFFFFFF
    ids[17:20] = [0, 1, 2**31 - 1]
    want = np.asarray(R.hash_uniform(jnp.uint32(salt), jnp.asarray(ids)))
    got = T.hash_uniform(salt, torch.as_tensor(ids)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    assert got.min() >= 0.0 and got.max() < 1.0


@pytest.mark.parametrize("seed", SEEDS)
def test_threefry_key_split_fold_in(seed):
    k = jax.random.key(seed)
    kt = T.key(seed)
    assert T.key_data(kt) == _kd(k)
    for num in (2, 3):
        want = [_kd(x) for x in jax.random.split(k, num)]
        assert T.split(kt, num) == want
    for data in (0, 1, 2, 1000, 2**32 - 1):
        assert T.fold_in(kt, data) == _kd(jax.random.fold_in(k, data))


@pytest.mark.parametrize("seed", SEEDS[:4])
@pytest.mark.parametrize("shared", [False, True])
def test_layer_salts_from_key(seed, shared):
    k = jax.random.fold_in(jax.random.key(seed), 3)
    kt = T.fold_in(T.key(seed), 3)
    want = [int(x) for x in R.layer_salts_from_key(k, 3, shared=shared)]
    assert T.layer_salts_from_key(kt, 3, shared=shared) == want
    assert T.salt_from_key(kt) == int(R.salt_from_key(k))


@pytest.mark.parametrize("salt", [0, 5, 2**32 - 1])
def test_layer_salts_from_uint32(salt):
    for shared in (False, True):
        want = [int(x) for x in
                R.layer_salts_from_uint32(jnp.uint32(salt), 4, shared=shared)]
        assert T.layer_salts_from_uint32(salt, 4, shared=shared) == want


def test_serving_salt_schedule_matches_reference():
    """The request loop of launch/serve.py: key(seed + 1), then one
    split per request; each request's layer salts must match."""
    key, kt = jax.random.key(4), T.key(4)
    for _ in range(5):
        key, sk = jax.random.split(key)
        kt, skt = T.split(kt)
        want = [int(x) for x in R.layer_salts_from_key(sk, 3)]
        assert T.layer_salts_from_key(skt, 3) == want
