"""MoE in repro_torch against repro on the CPU, at ``reduce_cfg`` sizes
of qwen3-moe-235b-a22b (d 64, 8 experts of 48, top-2, GQA 4/2 heads of
16, vocab 257), B = 2, S = 40:

  * ``moe_init`` bit for bit, with and without the shared expert, and
    reduced qwen3-moe ``init_params``;
  * the routing (``moe_route``) on repro's router probabilities bit for
    bit: experts, slots, keep masks and weights, with
    ``poisson_capacity`` off and on, at the default capacity and at one
    that drops tokens (capacity factor 0: C = 8 slots an expert against
    10 tokens on average), and at top-4 (24 slots against 20). repro's
    routing lives inside ``moe_apply``; the test records its
    probabilities and its three stacked (B, k, S) arrays while it runs;
  * ``moe_apply`` (capacity dropping, Poisson, shared expert), and with
    repro's parameters ``forward``, ``prefill`` with its caches and 8
    teacher-forced ``decode_step``s with the same greedy tokens, within
    rtol 1e-4 / atol 1e-5;
  * one train step: the loss, the gradient norm and every updated
    parameter within rtol 1e-4 / atol 1e-5, but for the entries of a
    nonzero gradient below 1e-5 of its tensor's largest, held to 2 x lr
    (``test_torch_lm_train.py`` says why); at most 1e-3 of the entries
    may be outside rtol 1e-4 / atol 1e-5 and inside 2 x lr.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs in parallel workers, and torch's
# OpenMP threads spinning against them slow every worker several-fold
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.configs.reduce import reduce_cfg as jreduce  # noqa: E402
from repro.models.transformer import layers as JL  # noqa: E402
from repro.models.transformer import lm as JLM  # noqa: E402
from repro.models.transformer import stack as JS  # noqa: E402
from repro.optim import adam as JA  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.configs.reduce import reduce_cfg as treduce  # noqa: E402
from repro_torch.core import rng as TR  # noqa: E402
from repro_torch.models.transformer import layers as TL  # noqa: E402
from repro_torch.models.transformer import lm as TLM  # noqa: E402
from repro_torch.models.transformer import stack as TS  # noqa: E402
from repro_torch.optim import adam as TA  # noqa: E402

ARCH = "qwen3-moe-235b-a22b"
B, S, STEPS = 2, 40, 8
TOL = dict(rtol=1e-4, atol=1e-5)


def _cfgs(**moe):
    j = jreduce(jconfigs.get_config(ARCH, dtype="float32"))
    t = treduce(tconfigs.get_config(ARCH, dtype="float32"))
    return (dataclasses.replace(j, moe=dataclasses.replace(j.moe, **moe)),
            dataclasses.replace(t, moe=dataclasses.replace(t.moe, **moe)))


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: np.asarray(tree)}
    out = {}
    for k, v in items:
        out.update(_flat(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def _torch(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


def _bits_equal(got, want, path):
    assert got.dtype == want.dtype and got.shape == want.shape, path
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32),
                                  err_msg=path)


@pytest.mark.parametrize("shared", [False, True])
def test_moe_init_is_bit_exact(shared):
    jcfg, tcfg = _cfgs(shared_expert=shared)
    want = _flat(JL.moe_init(jax.random.key(2), jcfg))
    got = _flat(TL.moe_init(TR.key(2), tcfg))
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        _bits_equal(got[path], w, path)
    want = _flat(JS.init_params(jax.random.key(3), jcfg))
    got = _flat(TS.init_params(TR.key(3), tcfg))
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        _bits_equal(got[path], w, path)


def _repro_routing(jp, x, jcfg, monkeypatch):
    """repro's ``moe_apply`` run op by op, recording its router
    probabilities and its stacked indices, keeps and weights."""
    seen = {"stacks": []}
    softmax, stack = jax.nn.softmax, jnp.stack

    def spy_softmax(*a, **kw):
        seen["probs"] = softmax(*a, **kw)
        return seen["probs"]

    def spy_stack(arrays, *a, **kw):
        out = stack(arrays, *a, **kw)
        seen["stacks"].append(out)
        return out

    monkeypatch.setattr(jax.nn, "softmax", spy_softmax)
    monkeypatch.setattr(jnp, "stack", spy_stack)
    out = JL.moe_apply(jp, jnp.asarray(x), jcfg)
    monkeypatch.undo()
    idx, keep, w = seen["stacks"][-3:]
    return (np.asarray(seen["probs"]), np.asarray(idx), np.asarray(keep),
            np.asarray(w), np.asarray(out))


@pytest.mark.parametrize("moe", [dict(), dict(poisson_capacity=True),
                                 dict(capacity_factor=0.0),
                                 dict(capacity_factor=0.0,
                                      poisson_capacity=True),
                                 dict(top_k=4, capacity_factor=0.5)],
                         ids=["default", "poisson", "drops",
                              "drops-poisson", "top4"])
def test_routing_is_bit_exact_on_repros_probabilities(moe, monkeypatch):
    jcfg, tcfg = _cfgs(**moe)
    jp = JL.moe_init(jax.random.key(4), jcfg)
    x = np.random.default_rng(0).normal(size=(B, S, 64)).astype(np.float32)
    probs, idx, keep, w, out = _repro_routing(jp, x, jcfg, monkeypatch)
    C = TL._moe_capacity(tcfg.moe, S)
    assert C == JL._moe_capacity(jcfg.moe, S)
    experts, slots, keeps, ws = TL.moe_route(torch.from_numpy(probs.copy()),
                                             tcfg.moe, C)
    assert keeps.shape == (B, tcfg.moe.top_k, S)
    np.testing.assert_array_equal(experts.numpy(), np.asarray(
        jax.lax.top_k(jnp.asarray(probs), tcfg.moe.top_k)[1]))
    np.testing.assert_array_equal(keeps.numpy(), keep)
    np.testing.assert_array_equal(torch.where(keeps, slots, 0).numpy(), idx)
    _bits_equal(ws.numpy(), w, "weights")
    if "capacity_factor" in moe:
        assert not keep.all()   # this capacity drops tokens
    # and the whole block, from the same parameters
    got = TL.moe_apply(_torch(jp), torch.from_numpy(x), tcfg)
    np.testing.assert_allclose(got.numpy(), out, **TOL)


def test_top_k_breaks_ties_to_the_lower_index():
    p = np.array([[0.1, 0.3, 0.3, 0.2, 0.3, 0.0]], np.float32)
    want = jax.lax.top_k(jnp.asarray(p), 3)
    got = TL._top_k(torch.from_numpy(p), 3)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))


def test_moe_apply_with_shared_expert_matches_repro():
    jcfg, tcfg = _cfgs(shared_expert=True, capacity_factor=0.5)
    jp = JL.moe_init(jax.random.key(6), jcfg)
    x = np.random.default_rng(1).normal(size=(B, S, 64)).astype(np.float32)
    want = jax.jit(lambda p, x: JL.moe_apply(p, x, jcfg))(jp, jnp.asarray(x))
    got = TL.moe_apply(_torch(jp), torch.from_numpy(x), tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.fixture(scope="module")
def run():
    jcfg, tcfg = _cfgs()
    jp = JS.init_params(jax.random.key(1), jcfg)
    tp = TS.params_from_jax(jax.tree.map(np.asarray, jp), tcfg)
    tokens = np.random.default_rng(2).integers(0, tcfg.vocab, (B, S)).astype(
        np.int32)
    return jcfg, tcfg, jp, tp, tokens


def test_forward_prefill_and_decode_match_repro(run):
    jcfg, tcfg, jp, tp, tokens = run
    want = jax.jit(lambda p, t: JS.forward(p, t, jcfg))(jp, tokens)
    got = TS.forward(tp, torch.from_numpy(tokens), tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    jlogits, jcache = jax.jit(lambda p, t: JS.prefill(p, t, jcfg))(jp,
                                                                   tokens)
    tlogits, tcache = TS.prefill(tp, torch.from_numpy(tokens), tcfg)
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), **TOL)
    for tc, jc in zip(tcache, jcache):
        for n in ("k", "v"):
            np.testing.assert_allclose(tc[n].numpy(), np.asarray(jc[n]),
                                       **TOL)
    jcache = jax.tree.map(
        lambda a: jnp.pad(a, ((0, 0), (0, 0), (0, STEPS), (0, 0), (0, 0))),
        jcache)
    tcache = TS.widen_cache(tcache, STEPS)
    decode = jax.jit(lambda p, t, c, pos: JS.decode_step(p, t, c, pos, jcfg))
    tok = jnp.argmax(jlogits, -1).astype(jnp.int32)[:, None]
    for i in range(STEPS):
        jl, jcache = decode(jp, tok, jcache, jnp.int32(S + i))
        tl, _ = TS.decode_step(tp, torch.from_numpy(np.array(tok)), tcache,
                               S + i, tcfg)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL,
                                   err_msg=f"decode step {i}")
        nxt = jnp.argmax(jl, -1).astype(jnp.int32)
        np.testing.assert_array_equal(tl.argmax(-1).numpy(), np.asarray(nxt))
        tok = nxt[:, None]


def test_train_step_matches_repro(run):
    jcfg, tcfg, jp, tp, _ = run
    # fresh tensors: the step updates them in place
    tp = TS.params_from_jax(jax.tree.map(np.asarray, jp), tcfg)
    jopt, topt = JA.AdamConfig(lr=1e-3), TA.AdamConfig(lr=1e-3)
    rng = np.random.default_rng(3)
    toks = rng.integers(0, tcfg.vocab, (B, S + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    tbatch = {k: torch.from_numpy(v.copy()) for k, v in batch.items()}
    _, grads = TLM.make_grad_fn(tcfg)(tp, tbatch)
    assert float(grads["layers/0/0/ffn/ewi"].abs().sum()) > 0
    jp2, _, jm = jax.jit(JLM.make_train_step(jcfg, jopt))(
        jp, JA.init_state(jp, jopt),
        {k: jnp.asarray(v) for k, v in batch.items()})
    tp, _, tm = TLM.make_train_step(tcfg, topt)(
        tp, TLM.init_opt_state(tp, topt), tbatch)
    np.testing.assert_allclose(tm["loss"].item(), float(jm["loss"]), **TOL)
    np.testing.assert_allclose(tm["grad_norm"].item(),
                               float(jm["grad_norm"]), **TOL)
    want = _flat(jp2)      # per-repeat lists: scan_layers is off
    got = _flat(tp)
    assert sorted(got) == sorted(want)
    # the experts' tensors hold many small gradients (an expert sees few
    # tokens: 237 of 119,616 entries below 1e-5 of their tensor's
    # largest), so the cap is on the entries that rest on the 2 x lr
    # bound, outside rtol 1e-4 / atol 1e-5: at most 1e-3 of them all
    loose = 0
    for path, w in want.items():
        g = grads[path]
        n = ((g != 0) & (g.abs() < 1e-5 * g.abs().max())).numpy()
        np.testing.assert_allclose(got[path][~n], w[~n], **TOL,
                                   err_msg=path)
        assert np.all(np.abs(got[path] - w)[n] <= 2 * topt.lr), path
        loose += int((~np.isclose(got[path], w, **TOL))[n].sum())
    assert loose <= 1e-3 * sum(w.size for w in want.values())
