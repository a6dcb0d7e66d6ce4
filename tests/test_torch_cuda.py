"""The CUDA kernels of repro_torch against their plain versions, on the
card. No JAX here: the machine with the card has none. Every test is
marked ``cuda`` and skips without a card; run them there with

  PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch import ops as TO  # noqa: E402
from repro_torch.core import rng as TR  # noqa: E402
from repro_torch.core import samplers as TS  # noqa: E402
from repro_torch.core.interface import INT_FIELDS, pad_seeds  # noqa: E402
from repro_torch.graph.generators import paper_dataset  # noqa: E402
from repro_torch.kernels.frontier import ops as fk  # noqa: E402
from repro_torch.kernels.frontier import ref as fr  # noqa: E402
from repro_torch.models.gnn import gcn_init  # noqa: E402
from repro_torch.runtime.engine import TrainEngine  # noqa: E402


@pytest.fixture
def cuda_device():
    """The card, decided when the test runs (the kernels have no CPU
    mode); skipped where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("E", [1, 255, 2048, 4097, 50_000])
def test_frontier_kernels_match_plain(cuda_device, E):
    """compact, compact_perm and hash_dedup at tile-boundary sizes, with
    and without the n_live prefix, overflow included."""
    g = torch.Generator(device=cuda_device).manual_seed(E)
    live = torch.tensor(E - E // 3, dtype=torch.int32, device=cuda_device)
    prefix = torch.arange(E, device=cuda_device) < live
    flags = (torch.rand(E, generator=g, device=cuda_device) < 0.4) & prefix
    for n in (None, live):
        for got, want in zip(fk.compact(flags, E // 2 + 1, n),
                             fr.compact(flags, E // 2 + 1)):
            assert torch.equal(got, want)
    keys = torch.randint(-1, 300, (E,), generator=g, device=cuda_device,
                         dtype=torch.int32)
    assert torch.equal(fk.compact_perm(keys, prefix, 300, live),
                       fr.compact_perm(keys, prefix, 300))
    seeds = torch.randperm(400, generator=g, device=cuda_device)[:50].to(
        torch.int32)
    for new_cap in (5, E):
        got = fk.hash_dedup(keys, prefix, seeds, new_cap, live)
        want = fr.hash_dedup(keys, prefix, seeds, new_cap)
        for x, y in zip(got, want):
            assert torch.equal(x, y)


@pytest.fixture(scope="module")
def served():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    ds = paper_dataset("products", 0.004, seed=2)
    sampler = TS.from_dataset("labor-0", ds, batch_size=64, fanouts=(5, 5, 5))
    out = {}
    for backend in ("cuda", "eager"):
        eng = TrainEngine(sampler, device="cuda", backend=backend)
        data = eng.make_data_from_dataset(ds)
        model = gcn_init(0, 100, 32, 47, 3, device="cuda")
        out[backend] = eng.infer_blocks(model, data,
                                        pad_seeds(ds.val_idx[:60], 64,
                                                  device="cuda"),
                                        TR.key(11))
    return out


@pytest.mark.cuda
def test_spmm_on_a_sampled_block(served):
    """The SpMM kernel fed blocks straight from the sampler."""
    for blk in served["cuda"][2]:
        for F in (100, 256):
            h = torch.randn(blk.next_cap, F, device="cuda")
            torch.testing.assert_close(TO.aggregate(blk, h, backend="cuda"),
                                       TO.aggregate(blk, h, backend="eager"),
                                       rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_serving_path_kernels_match_plain(served):
    """One request end to end: blocks bit for bit, logits to 1e-4."""
    (lk, fk_, bk), (le, fe, be) = served["cuda"], served["eager"]
    assert torch.equal(fk_, fe)
    for a, b in zip(bk, be):
        for f in INT_FIELDS:
            assert torch.equal(getattr(a, f), getattr(b, f)), f
        torch.testing.assert_close(a.weight, b.weight, rtol=1e-6, atol=1e-7)
    torch.testing.assert_close(lk, le, rtol=1e-4, atol=1e-4)
