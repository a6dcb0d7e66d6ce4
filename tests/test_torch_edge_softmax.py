"""The edge softmax's plain version (``repro_torch/kernels/edge_softmax/
ref.py``, the yardstick of the card kernel ``csrc/edge_softmax.cu``)
against ``repro``'s: the Pallas kernel behind ``edge_softmax_block`` in
interpret mode, and ``repro.kernels.edge_softmax.ref.edge_softmax_ref``,
on the same numpy-seeded inputs, at the shapes the card kernel's paths
take: rows longer than its long-row threshold (128 edges), one row
holding every edge, 1, 3, 8 and 128 heads, masked edges inside the
dst-sorted prefix, and rows 200 apart in logits (a shift shared by the
rows would underflow the low ones to 0). rtol = atol = 1e-6: the three
take each row's max exactly and differ only in the order of the
denominator's sum.

``edge_softmax_block``'s layout (``prepare_chunks``) places an edge by
its index among the masked-in edges, so its contract has them as a
prefix with the masked edges after it; the Pallas kernel is therefore
given each case's masked-in edges moved to the front (a stable
partition), and its coefficients are put back at their edges. The
softmax of an edge depends only on the masked-in edges of its row, so
that is the same function of the same inputs.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one thread a worker: the test files run in parallel, a worker each
torch.set_num_threads(1)
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.edge_softmax import ref as jref  # noqa: E402
from repro.kernels.edge_softmax.ops import edge_softmax_block  # noqa: E402
from repro_torch.kernels.edge_softmax import ops as ek  # noqa: E402
from repro_torch.kernels.edge_softmax import ref as er  # noqa: E402

TOL = 1e-6

#: name -> (edges, rows, heads, live edges, masked share inside the prefix,
#: spread of the rows' logits)
CASES = {
    "long rows": (3000, 4, 8, 2900, 0.0, 0.0),
    "one row holds every edge": (2000, 1, 3, 2000, 0.0, 0.0),
    "1 head, masked inside the prefix": (4000, 300, 1, 3500, 0.3, 0.0),
    "3 heads, spread 200": (3001, 200, 3, 2999, 0.1, 200.0),
    "8 heads, spread 200, masked": (5000, 300, 8, 4500, 0.2, 200.0),
    "128 heads, long rows, spread 200": (700, 3, 128, 650, 0.1, 200.0),
}


def _case(name):
    """A block-like layout: a dst-sorted prefix of ``live`` edges over the
    rows (-1 and masked past it), some masked edges inside it, and
    logits with a per-row offset."""
    E, S, H, live, masked, spread = CASES[name]
    rng = np.random.default_rng(len(name) * 1000 + E)
    dst = np.sort(rng.integers(0, S, E)).astype(np.int32)
    in_prefix = np.arange(E) < live
    dst = np.where(in_prefix, dst, -1).astype(np.int32)
    mask = in_prefix & (rng.random(E) >= masked)
    offset = (rng.random(S) - 0.5) * spread
    logits = (rng.normal(size=(E, H)) * 3
              + offset[np.maximum(dst, 0)][:, None]).astype(np.float32)
    return dst, mask, logits, S


@pytest.fixture(scope="module")
def references():
    """repro's two results of every case, computed once."""
    out = {}
    for name in CASES:
        dst, mask, logits, S = _case(name)
        args = (jnp.asarray(dst), jnp.asarray(mask), jnp.asarray(logits))
        order = np.argsort(~mask, kind="stable")
        front = np.where(mask[order], dst[order], -1).astype(np.int32)
        pallas = np.empty_like(logits)
        pallas[order] = np.asarray(edge_softmax_block(
            jnp.asarray(front), jnp.asarray(mask[order]),
            jnp.asarray(logits[order]), S, interpret=True))
        out[name] = {"pallas interpret": pallas,
                     "ref": np.asarray(jref.edge_softmax_ref(*args, S))}
    return out


@pytest.mark.parametrize("oracle", ["pallas interpret", "ref"])
@pytest.mark.parametrize("name", list(CASES))
def test_plain_edge_softmax_matches_repro(references, name, oracle):
    dst, mask, logits, S = _case(name)
    got = er.edge_softmax_ref(torch.as_tensor(dst), torch.as_tensor(mask),
                              torch.as_tensor(logits), S).numpy()
    np.testing.assert_allclose(got, references[name][oracle], rtol=TOL,
                               atol=TOL)
    assert np.all(got[~mask] == 0)
    sums = np.zeros((S, logits.shape[1]))
    np.add.at(sums, dst[mask], got[mask])
    np.testing.assert_allclose(sums[np.unique(dst[mask])], 1.0, atol=1e-5)


@pytest.mark.parametrize("name", list(CASES))
def test_wrapper_on_the_cpu_is_the_plain_version(name):
    """On CPU tensors the wrapper runs ``ref.py`` itself, whatever n_live
    says (the edges past it are masked)."""
    dst, mask, logits, S = _case(name)
    t = [torch.as_tensor(a) for a in (dst, mask, logits)]
    live = torch.tensor(CASES[name][3], dtype=torch.int32)
    assert torch.equal(ek.edge_softmax_rows(*t, S, live),
                       er.edge_softmax_ref(*t, S))
