"""The LABOR-0 serving slice of repro_torch, end to end, against repro on
a small graph (products at scale 0.004, batch 64, fanouts 5,5,5, hidden
32):

  * ``expand_seed_edges`` bit for bit, overflowing cap included;
  * three-layer LABOR-0 blocks under the same salts: every integer field
    bit for bit, ``weight`` to rtol 1e-6 / atol 1e-7, and the per-layer
    sampled-vertex counts (the paper's Table 2 metric);
  * ``TrainEngine.infer`` logits with the reference's parameters carried
    across, to rtol = atol = 1e-4 (three fp32 layers, other BLAS
    blocking);
  * the overflow-retry contract: the same number of cap doublings;
  * the launcher prints the reference launcher's JSON keys, sampler,
    ``exact`` flag, served counts, request size and accuracy, with
    LABOR-0, with the default sampler (``full``) and on a Zipfian trace
    of small requests; its request stream (``--request-size``,
    ``--trace``, ``--zipf-a``) holds the reference's seeds; every other
    registry entry serves through the port's launcher;
  * the port imports neither jax nor repro, and asks for CUDA by default.
"""
import argparse
import json
import re
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs in parallel workers, and torch's
# OpenMP threads spinning against them slow every worker several-fold
torch.set_num_threads(1)
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import samplers as JS  # noqa: E402
from repro.core.interface import LayerCaps as JCaps  # noqa: E402
from repro.core.interface import pad_seeds as jpad  # noqa: E402
from repro.graph.csr import expand_seed_edges as j_expand  # noqa: E402
from repro.graph.generators import paper_dataset as jds  # noqa: E402
from repro.models import gnn as jgnn  # noqa: E402
from repro.optim import adam  # noqa: E402
from repro.runtime.engine import TrainEngine as JEngine  # noqa: E402
from repro_torch.core import rng as TR  # noqa: E402
from repro_torch.core import samplers as TS  # noqa: E402
from repro_torch.core.interface import INT_FIELDS  # noqa: E402
from repro_torch.core.interface import LayerCaps as TCaps  # noqa: E402
from repro_torch.core.interface import pad_seeds as tpad  # noqa: E402
from repro_torch.graph.csr import expand_seed_edges as t_expand  # noqa: E402
from repro_torch.graph.generators import paper_dataset as tds  # noqa: E402
from repro_torch.models import gnn as tgnn  # noqa: E402
from repro_torch.ops.backend import resolve_backend  # noqa: E402
from repro_torch.runtime.engine import TrainEngine as TEngine  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
B, FANOUTS, HIDDEN = 64, (5, 5, 5), 32


@pytest.fixture(scope="module")
def dsets():
    return jds("products", 0.004, seed=0), tds("products", 0.004, seed=0)


@pytest.fixture(scope="module")
def samplers_(dsets):
    dj, dt = dsets
    kw = dict(batch_size=B, fanouts=FANOUTS)
    return JS.from_dataset("labor-0", dj, **kw), TS.from_dataset(
        "labor-0", dt, **kw)


def test_generator_and_caps_match(dsets, samplers_):
    dj, dt = dsets
    np.testing.assert_array_equal(np.asarray(dj.graph.indptr),
                                  dt.graph.indptr.numpy())
    np.testing.assert_array_equal(np.asarray(dj.graph.indices),
                                  dt.graph.indices.numpy())
    np.testing.assert_array_equal(dj.features, dt.features)
    np.testing.assert_array_equal(dj.labels, dt.labels)
    for a, b in (("train_idx", "train_idx"), ("val_idx", "val_idx")):
        np.testing.assert_array_equal(getattr(dj, a), getattr(dt, b))
    assert dj.max_in_degree == dt.max_in_degree
    sj, st = samplers_
    assert [vars(c) for c in sj.caps] == [vars(c) for c in st.caps]


@pytest.mark.parametrize("edge_cap", [4096, 300])   # 300 overflows
def test_expand_seed_edges_bit_exact(dsets, edge_cap):
    dj, dt = dsets
    seeds = np.concatenate([dj.val_idx[:40], -np.ones(24, np.int64)])
    j = j_expand(dj.graph, jpad(jnp.asarray(seeds), B), edge_cap)
    t = t_expand(dt.graph, tpad(seeds, B), edge_cap)
    assert (int(j["total"]) > edge_cap) == (edge_cap == 300)
    for f in ("seed_slot", "src", "mask", "seg_start", "deg", "total"):
        np.testing.assert_array_equal(t[f].numpy(), np.asarray(j[f]),
                                      err_msg=f)
        assert t[f].numpy().dtype == np.asarray(j[f]).dtype, f


@pytest.mark.parametrize("key_seed,n_seeds", [(0, 64), (5, 50), (9, 7)])
def test_three_layer_blocks_bit_exact(dsets, samplers_, key_seed, n_seeds):
    dj, _ = dsets
    sj, st = samplers_
    seeds = dj.val_idx[key_seed:key_seed + n_seeds]
    key = jax.random.fold_in(jax.random.key(key_seed), 1)
    kt = TR.fold_in(TR.key(key_seed), 1)
    # the jitted trace (eager ``sample`` compiles op by op); the same
    # blocks bit for bit by the reference's design
    bj = sj.sample_with_key(dj.graph, jpad(jnp.asarray(seeds), B), key)
    bt = st.sample(dsets[1].graph, tpad(seeds, B), st.spec.salts(kt))
    assert len(bj) == len(bt) == 3
    for layer, (a, b) in enumerate(zip(bj, bt)):
        for f in INT_FIELDS:
            x, y = np.asarray(getattr(a, f)), getattr(b, f).numpy()
            assert x.dtype == y.dtype, (layer, f)
            np.testing.assert_array_equal(y, x, err_msg=f"layer {layer} {f}")
        np.testing.assert_allclose(b.weight.numpy(), np.asarray(a.weight),
                                   rtol=1e-6, atol=1e-7)
        # the paper's Table 2 metric: sampled vertices per layer
        assert int(b.num_next) == int(a.num_next)
        assert not bool(b.overflow)


def _ref_params(dj):
    n_cls = int(dj.labels.max()) + 1
    p = jgnn.gcn_init(jax.random.key(3), dj.features.shape[1], HIDDEN, n_cls,
                      3)
    return p, {"layers": [{k: np.asarray(v) for k, v in layer.items()}
                          for layer in p["layers"]]}


def test_infer_logits_with_params_carried_across(dsets, samplers_):
    dj, dt = dsets
    sj, st = samplers_
    pj, tree = _ref_params(dj)
    model = tgnn.params_from_jax(tree, device="cpu")
    ej = JEngine(sj, jgnn.gcn_apply, adam.AdamConfig(), backend="xla")
    et = TEngine(st, device="cpu")
    dj_data, dt_data = ej.make_data_from_dataset(dj), et.make_data_from_dataset(dt)
    for i in range(2):
        seeds = dj.val_idx[i * B:(i + 1) * B]
        key = jax.random.split(jax.random.key(i))[1]
        kt = TR.split(TR.key(i))[1]
        lj, fj = ej.infer(pj, dj_data, jpad(jnp.asarray(seeds), B), key)
        lt, ft = et.infer(model, dt_data, tpad(seeds, B), kt)
        np.testing.assert_array_equal(ft.numpy(), np.asarray(fj))
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=1e-4,
                                   atol=1e-4)


def _tiny_caps(caps, cls):
    out, prev = [], B
    for c in caps:
        v = max(prev + 128, (c.vertex_cap // 4 + 127) // 128 * 128)
        out.append(cls(expand_cap=max(128, c.expand_cap // 8 // 128 * 128),
                       edge_cap=max(128, c.edge_cap // 8 // 128 * 128),
                       vertex_cap=v))
        prev = v
    return out


def test_forced_tiny_caps_grow_like_the_reference(dsets, samplers_):
    dj, dt = dsets
    sj, st = samplers_
    pj, tree = _ref_params(dj)
    sj = JS.get("labor-0", FANOUTS, _tiny_caps(sj.caps, JCaps))
    st = TS.get("labor-0", FANOUTS, _tiny_caps(st.caps, TCaps))
    ej = JEngine(sj, jgnn.gcn_apply, adam.AdamConfig(), backend="xla")
    et = TEngine(st, device="cpu")
    seeds = dj.val_idx[:B]
    key, kt = jax.random.key(21), TR.key(21)
    lj, gj = ej.infer_with_retry(pj, ej.make_data_from_dataset(dj),
                                 jpad(jnp.asarray(seeds), B), key)
    lt, gt = et.infer_with_retry(tgnn.params_from_jax(tree, device="cpu"),
                                 et.make_data_from_dataset(dt),
                                 tpad(seeds, B), kt)
    assert gj >= 1 and gt == gj
    assert et.generation == gj
    assert [vars(c) for c in et.sampler.caps] == [vars(c) for c in ej.sampler.caps]
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=1e-4,
                               atol=1e-4)


SERVE_ARGS = ["--workload", "gnn", "--driver", "off", "--dataset",
              "products", "--scale", "0.004", "--sampler", "labor-0",
              "--fanouts", "5,5,5", "--hidden", "32", "--batch", "64",
              "--requests", "2"]


ZIPF_ARGS = ["--request-size", "32", "--trace", "zipf", "--zipf-a", "1.1"]


@pytest.mark.parametrize("sampler", ["labor-0", None])
def test_launcher_prints_the_reference_keys(sampler, monkeypatch, capsys):
    """Both launchers on the same surface, with ``--sampler labor-0`` on a
    Zipfian trace of 32-seed requests padded to the batch, and with no
    ``--sampler`` at all (the default, ``full``) on the default scan of
    full batches: the same keys, sampler, ``exact`` flag, served counts,
    request size and accuracy (same weights from the same seed, the same
    requests and blocks)."""
    from repro.launch import serve as jserve
    from repro_torch.launch import serve as tserve
    args = SERVE_ARGS + ZIPF_ARGS
    if sampler is None:
        i = SERVE_ARGS.index("--sampler")
        args = SERVE_ARGS[:i] + SERVE_ARGS[i + 2:]
    monkeypatch.setattr(sys, "argv", ["serve"] + args)
    jserve.main()
    ref = json.loads(capsys.readouterr().out)
    report = tserve.main(args + ["--device", "cpu"])
    out = json.loads(capsys.readouterr().out)
    assert set(out) == set(ref) and out == report
    assert out["requests_served"] == ref["requests_served"] == 2
    for k in ("sampler", "exact", "accuracy", "batches", "request_size",
              "batch", "avg_batch_occupancy", "grow_events", "timeouts",
              "rejected"):
        assert out[k] == ref[k], k
    assert out["backend"] == "eager"
    assert out["sampler"] == (sampler or "full")
    assert out["exact"] is (sampler is None)
    assert out["request_size"] == (64 if sampler is None else 32)


@pytest.mark.parametrize("trace,size", [("zipf", 256), ("scan", 100),
                                        ("scan", 0)])
def test_gnn_trace_matches_the_reference(dsets, trace, size):
    """The port's request stream takes the reference's flags and draws
    the reference's seeds: numpy's generator at seed + 7, the same Zipf
    weights over the validation ids, the same scan windows."""
    from repro.launch import serve as jserve
    from repro_torch.launch import serve as tserve
    dj, dt = dsets
    flags = ["--workload", "gnn", "--batch", "256", "--requests", "5",
             "--seed", "3", "--trace", trace, "--zipf-a", "1.1",
             "--request-size", str(size)]
    targs = tserve.parser().parse_args(flags)
    jargs = argparse.Namespace(batch=256, requests=5, seed=3, trace=trace,
                               zipf_a=1.1, request_size=size)
    want = jserve._gnn_trace(jargs, dj)
    got = tserve.gnn_trace(targs, dt)
    assert len(got) == len(want) == 5
    for a, b in zip(got, want):
        assert 0 < len(a) <= (size or 256)   # a scan stops at the ids' end
        np.testing.assert_array_equal(a, b)
    if trace == "zipf":   # skewed: repeats within a request
        assert len(np.unique(got[0])) < len(got[0])


@pytest.mark.parametrize("sampler", ["ns", "labor-1", "labor-*", "labor-d",
                                     "ladies", "pladies"])
def test_every_sampler_serves_through_the_launcher(sampler, capsys):
    """The registry's other entries serve on the CPU through the port's
    launcher; their blocks are held against repro's in the sampler
    tests."""
    from repro_torch.launch import serve as tserve
    i = SERVE_ARGS.index("--sampler")
    args = SERVE_ARGS[:i + 1] + [sampler] + SERVE_ARGS[i + 2:]
    report = tserve.main(args + ["--device", "cpu"])
    assert json.loads(capsys.readouterr().out) == report
    assert report["sampler"] == sampler and report["exact"] is False
    assert report["requests_served"] == report["batches"] == 2
    assert 0.0 <= report["accuracy"] <= 1.0


def test_cuda_is_the_default_device(samplers_):
    """Entry points run on the card unless the CPU is asked for."""
    from repro_torch.launch import serve as tserve
    assert tserve.parser().parse_args([]).device == "cuda"
    with pytest.raises(ValueError):
        resolve_backend("cuda", "cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            TEngine(samplers_[1])
        with pytest.raises(RuntimeError):
            tserve.main(SERVE_ARGS)


def test_unported_paths_say_so():
    """What the port refuses says so: an unknown sampler name, and an
    unknown LM block kind. Every LM block of the reference is ported:
    the LM workload serves a cross-attention config, the source drawn by
    the launcher and its cross K/V kept at the source's length
    (weighted graphs, the async driver and the LM blocks:
    tests/test_torch_weighted.py, tests/test_torch_serving_driver.py,
    tests/test_torch_mamba.py, tests/test_torch_moe.py and
    tests/test_torch_encdec.py)."""
    import dataclasses
    from repro_torch.launch import serve as tserve
    from repro_torch.models.transformer import stack as tstack
    with pytest.raises(TS.UnknownSamplerError):
        TS.resolve("labor-one")
    args = tserve.parser().parse_args(
        SERVE_ARGS + ["--device", "cpu", "--workload", "lm", "--arch",
                      "mamba2-370m", "--reduce", "--prompt-len", "8",
                      "--gen", "2"])
    cfg, _, prompts = tserve.build_lm(args)
    xattn = dataclasses.replace(cfg, layer_pattern=("mamba", "xattn"),
                                mixers=("none", "none"), num_layers=2,
                                xattn_source_len=5)
    params = tstack.init_params(TR.key(args.seed), xattn)
    out = tserve.serve_lm(args, (xattn, params, prompts))
    assert out["tokens"].shape == (args.batch, 2)
    assert out["cache"][1]["xk"].shape[2] == 5
    unknown = dataclasses.replace(xattn, layer_pattern=("mamba", "conv"))
    with pytest.raises(ValueError, match="unknown block kind"):
        tserve.serve_lm(args, (unknown, params, prompts))


_IMPORT = re.compile(r"^\s*(import|from)\s+(jax|repro)(\.|\s|$)")


def test_port_imports_neither_jax_nor_repro():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 20
    bad = [f"{f.relative_to(ROOT)}:{i}: {line.strip()}"
           for f in files
           for i, line in enumerate(f.read_text().splitlines(), 1)
           if _IMPORT.match(line)]
    assert not bad, bad
