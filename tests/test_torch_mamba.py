"""Mamba2 and zamba2's shared attention in repro_torch against repro on
the CPU, at ``reduce_cfg`` sizes (d 64, SSM d_state 16, head_dim 16,
chunk 16, so 8 SSM heads; zamba2: 5 Mamba2 blocks and the shared
attention + MLP of 4 heads of 16, vocab 257), B = 2, S = 40 (no
multiple of the chunk):

  * ``A_log`` (``log(linspace(1, 16, nh))``, XLA's CPU log) at the
    head counts of the registry and around them, ``mamba_init`` and
    reduced mamba2-370m / zamba2-2.7b ``init_params`` bit for bit, in
    both of repro's layouts (per-repeat ``fold_in`` keys, and the
    ``split`` keys of ``scan_layers=True``, through ``params_from_jax``);
  * ``ssd_chunked`` with S = 37 and chunk 16 (dt = 0 padding), two
    groups over four heads and an initial state; ``mamba_apply`` over a
    sequence and one decode step from its states;
  * with repro's parameters: ``forward``, ``prefill`` with every cache
    tensor (``conv``, ``ssm``, and the shared attention's K/V), then 8
    teacher-forced ``decode_step``s with the same greedy tokens, all
    within rtol 1e-4 / atol 1e-5;
  * one zamba2 train step, with remat off and on in both packages: the
    loss, the gradient norm and every updated parameter within rtol
    1e-4 / atol 1e-5 (the shared set's gradient summed over its uses),
    but for the entries of a nonzero gradient below 1e-5 of its
    tensor's largest, held to 2 x lr (``test_torch_lm_train.py`` says
    why), which may be at most 1e-3 of the entries.

repro's functions run jitted with the config closed over.
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

B, S, STEPS = 2, 40, 8
TOL = dict(rtol=1e-4, atol=1e-5)


def _cfgs(arch, **kw):
    j = jreduce(jconfigs.get_config(arch, dtype="float32"))
    t = treduce(tconfigs.get_config(arch, dtype="float32"))
    return dataclasses.replace(j, **kw), dataclasses.replace(t, **kw)


def _flat(tree, prefix=""):
    """A tree's leaves by path, numpy (either package, any layout)."""
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


def _per_repeat(jparams, cfg):
    """repro's parameters with stacked layers split per repeat."""
    out = dict(jparams)
    out["layers"] = [entry if isinstance(entry, list) else
                     [jax.tree.map(lambda a: a[r], entry)
                      for r in range(cfg.repeats)]
                     for entry in jparams["layers"]]
    return out


def _bits_equal(got, want, path):
    assert got.dtype == want.dtype and got.shape == want.shape, path
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32),
                                  err_msg=path)


@pytest.mark.parametrize("nh", [1, 2, 8, 31, 32, 33, 80, 160, 352])
def test_a_log_is_bit_exact(nh):
    want = np.asarray(jnp.log(jnp.linspace(1.0, 16.0, nh)).astype(
        jnp.float32))
    _bits_equal(TL._a_log(nh, "cpu").numpy(), want, f"nh={nh}")


def test_mamba_init_is_bit_exact():
    jcfg, tcfg = _cfgs("mamba2-370m")
    want = _flat(JL.mamba_init(jax.random.key(3), jcfg))
    got = _flat(TL.mamba_init(TR.key(3), tcfg))
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        _bits_equal(got[path], w, path)


@pytest.mark.parametrize("arch,scan", [("mamba2-370m", False),
                                       ("mamba2-370m", True),
                                       ("zamba2-2.7b", False),
                                       ("zamba2-2.7b", True)])
def test_init_params_is_bit_exact(arch, scan):
    jcfg, tcfg = _cfgs(arch, scan_layers=scan)
    if scan:   # two repeats of the pattern, stacked in repro
        n = 2 * len(jcfg.layer_pattern)
        jcfg, tcfg = (dataclasses.replace(c, num_layers=n)
                      for c in (jcfg, tcfg))
    jp = JS.init_params(jax.random.key(7), jcfg)
    want = _flat(_per_repeat(jp, jcfg))
    got = _flat(TS.init_params(TR.key(7), tcfg))
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        _bits_equal(got[path], w, path)
    back = _flat(TS.params_from_jax(jax.tree.map(np.asarray, jp), tcfg))
    assert sorted(back) == sorted(want)
    for path, w in want.items():
        np.testing.assert_array_equal(back[path], w, err_msg=path)


def test_ssd_chunked_matches_repro():
    """S = 37 over chunks of 16 (padded with dt = 0), 2 groups over 4
    heads, a given initial state."""
    rng = np.random.default_rng(0)
    b, s, h, p, g, n, chunk = 2, 37, 4, 8, 2, 6, 16
    x = rng.normal(size=(b, s, h, p)).astype(np.float32)
    dtv = np.log1p(np.exp(rng.normal(size=(b, s, h)))).astype(np.float32)
    A = -np.exp(rng.normal(size=h)).astype(np.float32)
    Bm = rng.normal(size=(b, s, g, n)).astype(np.float32)
    Cm = rng.normal(size=(b, s, g, n)).astype(np.float32)
    init = rng.normal(size=(b, h, p, n)).astype(np.float32)
    ref = jax.jit(JL.ssd_chunked, static_argnums=5)
    for state in (None, init):
        wy, wf = ref(*map(jnp.asarray, (x, dtv, A, Bm, Cm)), chunk,
                     None if state is None else jnp.asarray(state))
        gy, gf = TL.ssd_chunked(*map(torch.from_numpy, (x, dtv, A, Bm, Cm)),
                                chunk,
                                None if state is None
                                else torch.from_numpy(state))
        assert gy.shape == (b, s, h, p) and gf.shape == (b, h, p, n)
        np.testing.assert_allclose(gy.numpy(), np.asarray(wy), **TOL)
        np.testing.assert_allclose(gf.numpy(), np.asarray(wf), **TOL)


def test_mamba_apply_matches_repro():
    """A sequence of 37 tokens with its conv and SSM states, then one
    decode step from them."""
    jcfg, tcfg = _cfgs("mamba2-370m")
    jp = JL.mamba_init(jax.random.key(5), jcfg)
    tp = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), jp)
    rng = np.random.default_rng(1)
    x = rng.normal(size=(B, 37, tcfg.d_model)).astype(np.float32)
    x1 = rng.normal(size=(B, 1, tcfg.d_model)).astype(np.float32)
    full = jax.jit(lambda p, x: JL.mamba_apply(p, x, jcfg))
    step = jax.jit(lambda p, x, c, s: JL.mamba_apply(
        p, x, jcfg, conv_state=c, ssm_state=s, decode=True))
    wy, (wc, ws) = full(jp, jnp.asarray(x))
    gy, (gc, gs) = TL.mamba_apply(tp, torch.from_numpy(x), tcfg)
    for got, want in ((gy, wy), (gc, wc), (gs, ws)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    wy, (wc, ws) = step(jp, jnp.asarray(x1), wc, ws)
    gy, (gc, gs) = TL.mamba_apply(tp, torch.from_numpy(x1), tcfg,
                                  conv_state=gc, ssm_state=gs, decode=True)
    for got, want in ((gy, wy), (gc, wc), (gs, ws)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    spec = TL.mamba_cache_spec(tcfg, 3)
    for n, t in JL.mamba_cache_spec(jcfg, 3).items():
        assert spec[n].shape == t.shape and not spec[n].any()
        assert str(spec[n].dtype).endswith(str(t.dtype))


class Run:
    """One arch's reduced config, repro's parameters in both packages and
    repro's jitted forward / prefill / decode on shared tokens."""

    def __init__(self, arch):
        self.jcfg, self.tcfg = _cfgs(arch)
        self.jp = JS.init_params(jax.random.key(1), self.jcfg)
        self.tp = TS.params_from_jax(jax.tree.map(np.asarray, self.jp),
                                     self.tcfg)
        rng = np.random.default_rng(2)
        self.tokens = rng.integers(0, self.tcfg.vocab, (B, S)).astype(
            np.int32)
        cfg = self.jcfg
        self.forward = jax.jit(lambda p, t: JS.forward(p, t, cfg))
        self.prefill = jax.jit(lambda p, t: JS.prefill(p, t, cfg))
        self.decode = jax.jit(
            lambda p, t, c, pos: JS.decode_step(p, t, c, pos, cfg))


@pytest.fixture(scope="module", params=["mamba2-370m", "zamba2-2.7b"])
def run(request):
    return Run(request.param)


def test_forward_matches_repro(run):
    want = run.forward(run.jp, jnp.asarray(run.tokens))
    got = TS.forward(run.tp, torch.from_numpy(run.tokens), run.tcfg)
    assert got.shape == (B, S, run.tcfg.vocab)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_prefill_and_decode_match_repro(run):
    """Last logits and every cache tensor of the prefill (Mamba2's conv
    and SSM states, the shared attention's K/V), then 8 decode steps
    teacher-forced with repro's greedy tokens from both packages'
    caches (widened by 8, as the launchers do: the states stay)."""
    jlogits, jcache = run.prefill(run.jp, jnp.asarray(run.tokens))
    tlogits, tcache = TS.prefill(run.tp, torch.from_numpy(run.tokens),
                                 run.tcfg)
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), **TOL)
    assert len(tcache) == len(jcache)
    kinds = set()
    for kind, tc, jc in zip(run.tcfg.layer_pattern, tcache, jcache):
        assert sorted(tc) == sorted(jc)
        kinds.update(tc)
        for n in tc:
            assert tuple(tc[n].shape) == jc[n].shape, (kind, n)
            np.testing.assert_allclose(tc[n].numpy(), np.asarray(jc[n]),
                                       **TOL, err_msg=f"{kind} {n}")
    assert {"conv", "ssm"} <= kinds

    def widen(a):
        if a.ndim != 5 or a.shape[2] != S:
            return a
        return jnp.pad(a, ((0, 0), (0, 0), (0, STEPS), (0, 0), (0, 0)))

    jcache = [{n: widen(a) if n in ("k", "v") else a for n, a in c.items()}
              for c in jcache]
    tcache = TS.widen_cache(tcache, STEPS)
    for tc, jc in zip(tcache, jcache):
        for n in tc:
            assert tuple(tc[n].shape) == jc[n].shape
    tok = jnp.argmax(jlogits, -1).astype(jnp.int32)[:, None]
    for i in range(STEPS):
        jl, jcache = run.decode(run.jp, tok, jcache, jnp.int32(S + i))
        tl, _ = TS.decode_step(run.tp, torch.from_numpy(np.array(tok)),
                               tcache, S + i, run.tcfg)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL,
                                   err_msg=f"decode step {i}")
        nxt = jnp.argmax(jl, -1).astype(jnp.int32)
        np.testing.assert_array_equal(tl.argmax(-1).numpy(), np.asarray(nxt))
        tok = nxt[:, None]
    for tc, jc in zip(tcache, jcache):
        for n in tc:
            np.testing.assert_allclose(tc[n].numpy(), np.asarray(jc[n]),
                                       **TOL, err_msg=f"after decode {n}")


def _zamba2_train_step(remat):
    """One zamba2 train step in both packages from repro's parameters,
    ``remat`` set in both configs."""
    jcfg, tcfg = _cfgs("zamba2-2.7b", remat=remat)
    jopt, topt = JA.AdamConfig(lr=1e-3), TA.AdamConfig(lr=1e-3)
    jp = JS.init_params(jax.random.key(8), jcfg)
    tp = TS.params_from_jax(jax.tree.map(np.asarray, jp), tcfg)
    rng = np.random.default_rng(3)
    toks = rng.integers(0, tcfg.vocab, (B, S + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    tbatch = {k: torch.from_numpy(v.copy()) for k, v in batch.items()}
    _, grads = TLM.make_grad_fn(tcfg)(tp, tbatch)
    # the shared set's gradient sums its uses: the same as autograd's
    # through one set, nonzero, and there once
    assert "shared/attn/wq" in grads and float(
        grads["shared/attn/wq"].abs().sum()) > 0
    jstep = jax.jit(JLM.make_train_step(jcfg, jopt))
    jp, _, jm = jstep(jp, JA.init_state(jp, jopt),
                      {k: jnp.asarray(v) for k, v in batch.items()})
    tp, to, tm = TLM.make_train_step(tcfg, topt)(
        tp, TLM.init_opt_state(tp, topt), tbatch)
    np.testing.assert_allclose(tm["loss"].item(), float(jm["loss"]), **TOL)
    np.testing.assert_allclose(tm["grad_norm"].item(),
                               float(jm["grad_norm"]), **TOL)
    want = _flat(_per_repeat(jp, jcfg))
    got = _flat(tp)
    assert sorted(got) == sorted(want)
    noise = {path: ((g != 0) & (g.abs() < 1e-5 * g.abs().max())).numpy()
             for path, g in grads.items()}
    assert sum(int(m.sum()) for m in noise.values()) <= 1e-3 * sum(
        w.size for w in want.values())
    for path, w in want.items():
        n = noise[path]
        np.testing.assert_allclose(got[path][~n], w[~n], **TOL,
                                   err_msg=path)
        assert np.all(np.abs(got[path] - w)[n] <= 2 * topt.lr), path
    assert int(to["step"]) == 1


def test_zamba2_train_step_matches_repro():
    _zamba2_train_step(remat=False)


def test_zamba2_train_step_with_remat_matches_repro():
    """remat on in both packages: the port checkpoints each repeat group
    (the shared set reached through the group's closure), repro wraps it
    in ``jax.checkpoint``."""
    _zamba2_train_step(remat=True)
