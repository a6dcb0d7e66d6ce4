"""The frontier primitives of repro_torch against repro: ``compact``,
``hash_dedup`` and ``compact_perm`` from the port's plain versions (what
the kernel wrappers run on a CPU tensor) against the reference's
``"xla"`` backend and its Pallas kernels in interpret mode. Every field
bit for bit, overflow included. The CUDA kernels themselves are held to
the same plain versions on the card by ``tests/test_torch_cuda.py`` and
``chip_smoke.py``."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs in parallel workers, and torch's
# OpenMP threads spinning against them slow every worker several-fold
torch.set_num_threads(1)
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import ops as O  # noqa: E402
from repro_torch.kernels.frontier import ops as fk  # noqa: E402
from repro_torch.ops import frontier as TF  # noqa: E402

BACKENDS = ("xla", "pallas")


def _eq(name, got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.dtype == want.dtype, (name, got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want, err_msg=name)


def _dedup_both(vals, mask, seeds, new_cap):
    t = TF.hash_dedup(torch.as_tensor(vals), torch.as_tensor(mask),
                      None if seeds is None else torch.as_tensor(seeds),
                      new_cap)
    for b in BACKENDS:
        r = O.hash_dedup(jnp.asarray(vals), jnp.asarray(mask),
                         None if seeds is None else jnp.asarray(seeds),
                         new_cap, backend=b)
        for f in ("new", "slots", "num_new", "overflow"):
            _eq(f"{b}:{f}", getattr(t, f), getattr(r, f))
    return t


def _random_dedup_case(rng):
    """Fixed buffer shapes (E = 256, S = 48, new_cap 16 or 64), so the
    reference's Pallas kernels compile once per shape; what varies is the
    fill, the duplicate density and the seed overlap."""
    E, S = 256, 48
    new_cap = int(rng.choice([16, 64]))
    id_range = int(rng.integers(4, 400))   # duplicate density
    vals = rng.integers(0, id_range, size=E).astype(np.int32)
    mask = rng.random(E) < rng.uniform(0.3, 1.0)
    seeds = np.unique(rng.integers(0, id_range, size=S - 3)).astype(np.int32)
    seeds = np.concatenate([seeds, -np.ones(S - len(seeds), np.int32)])
    return vals, mask, seeds, new_cap


@pytest.mark.parametrize("trial", range(8))
def test_hash_dedup_matches_reference(trial):
    _dedup_both(*_random_dedup_case(np.random.default_rng(trial)))


def _adversarial_dedup(name):
    E = 256
    rng = np.random.default_rng(7)
    seeds = np.concatenate([rng.permutation(500)[:40].astype(np.int32),
                            -np.ones(8, np.int32)])
    ones = np.ones(E, bool)
    if name == "all_masked":
        return rng.integers(0, 500, E).astype(np.int32), ~ones, seeds, 64
    if name == "all_duplicates":
        return np.full(E, 77, np.int32), ones, seeds, 64
    if name == "overflow":
        return rng.integers(0, 10_000, E).astype(np.int32), ones, seeds, 16
    if name == "equal_to_seeds":
        return np.resize(seeds[:40], E), ones, seeds, 16
    if name == "negative_values":
        return rng.integers(-1, 50, E).astype(np.int32), ones, seeds, 64
    if name == "no_seeds":
        return rng.integers(0, 90, E).astype(np.int32), \
            rng.random(E) < 0.5, None, 64
    if name == "empty_table":
        return np.full(E, -1, np.int32), ~ones, np.full(48, -1, np.int32), 16
    raise ValueError(name)


@pytest.mark.parametrize("name", ["all_masked", "all_duplicates", "overflow",
                                  "equal_to_seeds", "negative_values",
                                  "no_seeds", "empty_table"])
def test_hash_dedup_adversarial(name):
    vals, mask, seeds, new_cap = _adversarial_dedup(name)
    t = _dedup_both(vals, mask, seeds, new_cap)
    if name == "overflow":
        assert bool(t.overflow) and int(t.num_new) > new_cap
        # the smallest new_cap values survive; dropped values get slot -1
        uniq = np.setdiff1d(np.unique(vals), seeds)
        np.testing.assert_array_equal(t.new.numpy(), uniq[:new_cap])
        dropped = np.isin(vals, uniq[new_cap:])
        assert (t.slots.numpy()[dropped] == -1).all()


# fixed buffer sizes keep the reference's Pallas compiles to a few shapes
E_FIX = 256


@pytest.mark.parametrize("trial", range(8))
def test_compact_matches_reference(trial):
    rng = np.random.default_rng(100 + trial)
    cap = int(rng.choice([32, 300]))
    flags = rng.random(E_FIX) < rng.random()
    t = TF.compact(torch.as_tensor(flags), cap)
    for b in BACKENDS:
        r = O.compact(jnp.asarray(flags), cap, backend=b)
        for i, f in enumerate(("sel", "emask", "num")):
            _eq(f"{b}:{f}", t[i], r[i])


@pytest.mark.parametrize("case", ["none", "all_truncated", "one"])
def test_compact_adversarial(case):
    E, cap = (1, 1) if case == "one" else (E_FIX, 32)
    flags = np.full(E, case != "none")
    t = TF.compact(torch.as_tensor(flags), cap)
    for b in BACKENDS:
        r = O.compact(jnp.asarray(flags), cap, backend=b)
        for i in range(3):
            _eq(f"{b}:{i}", t[i], r[i])


@pytest.mark.parametrize("trial", range(8))
def test_compact_perm_matches_reference(trial):
    rng = np.random.default_rng(200 + trial)
    K = int(rng.choice([7, 50]))
    keys = rng.integers(-1, K, size=E_FIX).astype(np.int32)
    valid = rng.random(E_FIX) < rng.uniform(0.2, 1.0)
    t = TF.compact_perm(torch.as_tensor(keys), torch.as_tensor(valid), K)
    for b in BACKENDS:
        _eq(b, t, O.compact_perm(jnp.asarray(keys), jnp.asarray(valid), K,
                                 backend=b))


@pytest.mark.parametrize("case", ["all_minus_one", "all_invalid", "one_key"])
def test_compact_perm_adversarial(case):
    K = 1 if case == "one_key" else 50
    keys = np.full(E_FIX, -1 if case == "all_minus_one" else 0, np.int32)
    valid = np.full(E_FIX, case != "all_invalid")
    t = TF.compact_perm(torch.as_tensor(keys), torch.as_tensor(valid), K)
    for b in BACKENDS:
        _eq(b, t, O.compact_perm(jnp.asarray(keys), jnp.asarray(valid), K,
                                 backend=b))


def test_cpu_wrappers_run_the_plain_versions_and_launch_nothing():
    """On a CPU tensor a wrapper runs its plain version: same answer,
    no launch counted (the n_live hint is only read by the kernels)."""
    fk.reset_launches()
    rng = np.random.default_rng(3)
    vals, mask, seeds, new_cap = _random_dedup_case(rng)
    live = torch.tensor(len(vals), dtype=torch.int32)
    a = fk.hash_dedup(torch.as_tensor(vals), torch.as_tensor(mask),
                      torch.as_tensor(seeds), new_cap, live)
    b = TF.hash_dedup(torch.as_tensor(vals), torch.as_tensor(mask),
                      torch.as_tensor(seeds), new_cap, backend="eager")
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert fk.LAUNCHES == {"compact": 0, "hash_dedup": 0, "compact_perm": 0,
                           "segment_select": 0, "masked_cdf_draw": 0}
