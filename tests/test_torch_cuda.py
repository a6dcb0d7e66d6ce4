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
from repro_torch.kernels.spmm import ops as sk  # noqa: E402
from repro_torch.kernels.spmm import ref as sr  # noqa: E402
from repro_torch.models.gnn import gcn_init  # noqa: E402
from repro_torch.optim import adam  # noqa: E402
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
        model = gcn_init(TR.key(0), 100, 32, 47, 3, device="cuda")
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


def _segments(g, deg, cap, dev, tie_every=0):
    """An expand_seed_edges-style layout over ``cap`` slots (truncated
    when the degrees sum past it), keys with ties, take = min(k, d)
    with some takes of 0."""
    deg = torch.as_tensor(deg, dtype=torch.int32, device=dev)
    seg_start = (torch.cumsum(deg, 0, dtype=torch.int32) - deg)
    total = int(deg.sum())
    live = min(total, cap)
    pos = torch.arange(cap, device=dev)
    slot = (torch.searchsorted(torch.cumsum(deg, 0), pos, right=True)
            .to(torch.int32))
    mask = pos < live
    slot = torch.where(mask, slot, -1)
    keys = torch.rand(cap, generator=g, device=dev) * 4
    if tie_every:
        keys = torch.where(pos % tie_every == 0, torch.full_like(keys, 0.5),
                           keys)
    keys = torch.where(mask, keys, 3.4e38)
    take = torch.clamp(deg, max=10)
    take = torch.where(torch.arange(len(deg), device=dev) % 11 == 3, 0, take)
    return keys, slot, mask, seg_start, take.to(torch.int32), torch.tensor(
        live, dtype=torch.int32, device=dev)


@pytest.mark.cuda
@pytest.mark.parametrize("n_seg,max_deg,trunc", [(1, 1, 1.0), (7, 40, 1.0),
                                                 (300, 300, 1.0),
                                                 (2000, 1500, 0.6)])
def test_segment_select_kernel_matches_plain(cuda_device, n_seg, max_deg,
                                             trunc):
    """B6 bit for bit: warp-sized and block-sized (> 256) segments, ties,
    takes of 0, an expansion truncated at the cap."""
    g = torch.Generator(device=cuda_device).manual_seed(n_seg)
    deg = torch.randint(0, max_deg + 1, (n_seg,), generator=g,
                        device=cuda_device)
    deg[0] = max_deg
    cap = max(1, int(int(deg.sum()) * trunc))
    for tie in (0, 3):
        keys, slot, mask, seg_start, take, live = _segments(
            g, deg, cap, cuda_device, tie)
        want = fr.segment_select(keys, slot, mask, seg_start, take)
        for n in (None, live):
            got = fk.segment_select(keys, slot, mask, seg_start, take, n)
            assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("E", [1, 255, 4097])
@pytest.mark.parametrize("F", [1, 100, 128, 129, 256])
def test_gather_dst_kernel_matches_plain(cuda_device, E, F):
    """B5 bit for bit, with masked edges past the live count and -1 and
    out-of-range row indices reading nothing."""
    g = torch.Generator(device=cuda_device).manual_seed(E * F)
    S = 37
    dst = torch.randint(-1, S + 2, (E,), generator=g, device=cuda_device,
                        dtype=torch.int32)
    live = torch.tensor(E - E // 4, dtype=torch.int32, device=cuda_device)
    mask = torch.arange(E, device=cuda_device) < live
    rows = torch.randn(S, F, generator=g, device=cuda_device)
    want = sr.gather_dst_ref(dst, mask, rows)
    for n in (None, live):
        assert torch.equal(sk.gather_dst_rows(dst, mask, rows, n), want)


@pytest.mark.cuda
def test_transposed_spmm_on_a_sampled_block(served):
    """The SpMM kernel with roles swapped, fed a sampled block's
    src_perm, against the plain transposed version."""
    for blk in served["cuda"][2]:
        live = torch.clamp(blk.num_edges, max=blk.edge_cap)
        for F in (100, 256):
            gr = torch.randn(blk.seed_cap, F, device="cuda")
            args = (blk.src_slot, blk.dst_slot, blk.weight, blk.edge_mask,
                    blk.src_perm, gr, blk.next_cap)
            torch.testing.assert_close(sk.spmm_transposed(*args, n_live=live),
                                       sr.spmm_transposed_ref(*args),
                                       rtol=1e-5, atol=1e-5)


def _cdf_case(g, C, n, dev, plateaus=True):
    """A normalised CDF with zero-mass plateaus and u that hit its
    values exactly, 0 and values just below 1."""
    p = torch.rand(C, generator=g, device=dev) ** 4
    if plateaus:
        p = torch.where(torch.rand(C, generator=g, device=dev) < 0.3, 0.0, p)
    valid = torch.rand(C, generator=g, device=dev) < 0.9
    cdf = fr.normalized_cdf(p, valid)
    u = torch.rand(n, generator=g, device=dev)
    hits = cdf[torch.randint(0, C, (n // 4,), generator=g, device=dev)]
    u = torch.cat([u, hits, torch.tensor([0.0, 1.0 - 6e-8, 1.0 - 1e-7],
                                         device=dev)])
    return p, valid, cdf, u


@pytest.mark.cuda
@pytest.mark.parametrize("C,n", [(1, 5), (2, 64), (1000, 10_240),
                                 (1 << 20, 10_240), (9_426_304, 10_240)])
def test_cdf_search_kernel_matches_plain(cuda_device, C, n):
    """B7 bit for bit against the plain lockstep search and against
    torch.searchsorted (clamped), at LADIES's layer-2 size too."""
    g = torch.Generator(device=cuda_device).manual_seed(C)
    p, valid, cdf, u = _cdf_case(g, C, n, cuda_device)
    want = fr.cdf_search(cdf, u)
    got = fk.cdf_search(cdf, u)
    assert got.dtype == torch.int32 and torch.equal(got, want)
    lib = torch.clamp(torch.searchsorted(cdf, u), 0, C - 1).to(torch.int32)
    assert torch.equal(lib, want)
    assert torch.equal(fk.masked_cdf_draw(p, valid, u),
                       fr.masked_cdf_draw(p, valid, u))


@pytest.mark.cuda
def test_cdf_search_kernel_adversarial(cuda_device):
    """The regression weights of the reference's suite, an all-invalid
    p, u = 0 over an invalid entry 0, no draws, one entry."""
    dev = cuda_device
    ones = torch.ones
    cases = [
        (torch.cat([torch.full((4096,), 1e-7), torch.full((8,), 3e8),
                    torch.full((4096,), 1e-7)]), ones(8200, dtype=torch.bool),
         torch.tensor([0.0, 0.5, 1.0 - 1e-7, 1.0 - 6e-8])),
        (ones(9), torch.zeros(9, dtype=torch.bool),
         torch.tensor([0.0, 0.3, 0.999])),
        (torch.tensor([5.0, 1.0, 0.0, 2.0]),
         torch.tensor([False, True, True, True]), torch.tensor([0.0, 0.4])),
        (ones(5), ones(5, dtype=torch.bool), torch.zeros(0)),
        (torch.tensor([0.5]), ones(1, dtype=torch.bool),
         torch.tensor([0.0, 0.7])),
    ]
    for p, valid, u in cases:
        p, valid, u = p.to(dev), valid.to(dev), u.to(dev)
        got = fk.masked_cdf_draw(p, valid, u)
        assert torch.equal(got, fr.masked_cdf_draw(p, valid, u))
    assert got.tolist() == [0, 0]
    with pytest.raises(ValueError):
        fk.cdf_search(torch.zeros(0, device=dev), torch.zeros(3, device=dev))
    with pytest.raises(TypeError):
        fk.cdf_search(torch.zeros(4, device=dev, dtype=torch.float64),
                      torch.zeros(3, device=dev))


@pytest.mark.cuda
@pytest.mark.parametrize("sampler", ["labor-*", "ladies", "pladies"])
def test_float_decisions_are_deterministic_on_the_card(cuda_device, sampler):
    """The float sums that decide LABOR-*, LADIES and PLADIES (c_s,
    E[|T|], column norms, the CDF, the water-fill) and the Hajek
    denominators run in a fixed order: two runs of the plain versions
    and one of the kernels sample the same blocks, weights bit for
    bit."""
    ds = paper_dataset("products", 0.004, seed=2)
    smp = TS.from_dataset(sampler, ds, batch_size=64, fanouts=(5, 5, 5))
    graph = ds.graph.to(cuda_device)
    seeds = pad_seeds(ds.train_idx[:64], 64, device="cuda")
    runs = [smp.sample_with_key(graph, seeds, TR.key(9), backend=b)
            for b in ("eager", "eager", "cuda")]
    for blocks in runs[1:]:
        for a, b in zip(runs[0], blocks):
            for f in INT_FIELDS + ("weight",):
                assert torch.equal(getattr(a, f), getattr(b, f)), f


@pytest.mark.cuda
@pytest.mark.parametrize("sampler", ["labor-0", "ns", "labor-1", "labor-*",
                                     "labor-d", "ladies", "pladies"])
def test_train_step_cuda_matches_eager(cuda_device, sampler):
    """One train step with the kernels against the plain versions on the
    card: the same sampled counts, loss and parameters to 1e-4."""
    ds = paper_dataset("products", 0.004, seed=2)
    smp = TS.from_dataset(sampler, ds, batch_size=64, fanouts=(5, 5, 5))
    seeds = pad_seeds(ds.train_idx[:64], 64, device="cuda")
    out = {}
    fk.reset_launches()
    sk.reset_launches()
    for backend in ("cuda", "eager"):
        eng = TrainEngine(smp, adam.AdamConfig(), device="cuda",
                          backend=backend)
        data = eng.make_data_from_dataset(ds)
        model = gcn_init(TR.key(0), 100, 32, 47, 3, device="cuda")
        model, _, m = eng.step(model, eng.init_state(model), data, seeds,
                               TR.key(4))
        out[backend] = (model, m)
    assert sk.LAUNCHES["spmm_t"] == 2      # not for the first GCN layer
    assert (fk.LAUNCHES["segment_select"] > 0) == (sampler == "ns")
    assert (fk.LAUNCHES["masked_cdf_draw"] > 0) == (sampler == "ladies")
    (mk, m_k), (me, m_e) = out["cuda"], out["eager"]
    for f in ("sampled_v", "sampled_e", "overflow"):
        assert torch.equal(m_k[f], m_e[f]), f
    torch.testing.assert_close(m_k["loss"], m_e["loss"], rtol=1e-4,
                               atol=1e-5)
    for (n, a), (_, b) in zip(mk.named_parameters(), me.named_parameters()):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5, msg=n)
