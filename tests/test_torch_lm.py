"""The LM serving slice of repro_torch against repro on the CPU, at
``reduce_cfg`` sizes (d 64, 4 heads over 2 KV heads of 16, vocab 257;
gemma2's window 16, so S = 48 runs past it), B = 2:

  * ``rng.randint`` against ``jax.random.randint`` bit for bit;
  * ``init_params`` bit for bit, every leaf, at reduced gemma2-2b and
    stablelm-1.6b (per-repeat ``fold_in`` keys) and at a 4-layer
    ``scan_layers=True`` gemma2 (the ``split`` schedule the reference
    vmaps over); ``params_from_jax`` of both of repro's layouts;
  * with repro's parameters: ``norm_apply``, ``rope``, ``attn_apply``
    (local and global) and ``mlp_apply`` to rtol 1e-5 / atol 1e-6;
    ``forward`` logits to rtol 1e-4 / atol 1e-5 (XLA's and torch's
    tanh, exp and sums differ in the last bits); ``prefill``'s last
    logits and every K/V cache, then 8 teacher-forced ``decode_step``s,
    to the same bound with the same greedy tokens; ``cross_entropy``;
  * both serve launchers, ``--workload lm --arch gemma2-2b --reduce
    --batch 2 --prompt-len 32 --gen 8 --seed 3``: the same ``sample:``
    tokens.

repro's functions run jitted with the config closed over.
"""
import dataclasses
import sys

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
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.configs.reduce import reduce_cfg as treduce  # noqa: E402
from repro_torch.core import rng as TR  # noqa: E402
from repro_torch.models.transformer import layers as TL  # noqa: E402
from repro_torch.models.transformer import lm as TLM  # noqa: E402
from repro_torch.models.transformer import stack as TS  # noqa: E402

B, S, STEPS = 2, 48, 8
TOL = dict(rtol=1e-5, atol=1e-6)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-5)


def _cfgs(arch, **kw):
    j = jreduce(jconfigs.get_config(arch, dtype="float32"))
    t = treduce(tconfigs.get_config(arch, dtype="float32"))
    return dataclasses.replace(j, **kw), dataclasses.replace(t, **kw)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _leaves(tparams):
    """The port's params as {path: tensor}, in repro's per-repeat paths."""
    out = {}
    for k, v in tparams.items():
        if k == "layers":
            for i, reps in enumerate(v):
                for r, p in enumerate(reps):
                    for path, t in _flat(p):
                        out[f"layers/{i}/{r}/{path}"] = t
        else:
            for path, t in _flat(v, k):
                out[path] = t
    return out


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, f"{prefix}/{k}" if prefix else k)
    else:
        yield prefix, tree


def _jax_leaves(jparams, cfg):
    out = {}
    for k, v in jparams.items():
        if k == "layers":
            for i, entry in enumerate(v):
                for r in range(cfg.repeats):
                    p = (entry[r] if isinstance(entry, list)
                         else jax.tree.map(lambda a: a[r], entry))
                    for path, t in _flat(p):
                        out[f"layers/{i}/{r}/{path}"] = np.asarray(t)
        else:
            for path, t in _flat(v, k):
                out[path] = np.asarray(t)
    return out


@pytest.mark.parametrize("span", [257, 100_352, 256_000, 1_000_003])
def test_randint_matches_jax(span):
    for seed, shape in ((0, (2, 32)), (3, (1, 1)), (span % 101, (4097,))):
        want = np.asarray(jax.random.randint(jax.random.key(seed), shape, 0,
                                             span))
        got = TR.randint(TR.key(seed), shape, 0, span).numpy()
        assert got.dtype == want.dtype == np.int32
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("arch,kw", [("gemma2-2b", {}),
                                     ("stablelm-1.6b", {}),
                                     ("gemma2-2b", dict(num_layers=4,
                                                        scan_layers=True))])
def test_init_params_is_bit_exact(arch, kw):
    jcfg, tcfg = _cfgs(arch, **kw)
    jp = JS.init_params(jax.random.key(7), jcfg)
    want = _jax_leaves(jp, jcfg)
    got = _leaves(TS.init_params(TR.key(7), tcfg))
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        g = got[path].numpy()
        assert g.dtype == w.dtype and g.shape == w.shape, path
        np.testing.assert_array_equal(g.view(np.int32), w.view(np.int32),
                                      err_msg=path)
    # params_from_jax takes either layout and gives the same tensors
    for path, t in _leaves(TS.params_from_jax(_np_tree(jp), tcfg)).items():
        np.testing.assert_array_equal(t.numpy(), want[path], err_msg=path)


class Run:
    """One arch's reduced config, repro's parameters in both packages and
    repro's jitted forward / prefill / decode on shared tokens."""

    def __init__(self, arch):
        self.jcfg, self.tcfg = _cfgs(arch)
        self.jp = JS.init_params(jax.random.key(1), self.jcfg)
        self.tp = TS.params_from_jax(_np_tree(self.jp), self.tcfg)
        rng = np.random.default_rng(2)
        self.tokens = rng.integers(0, self.tcfg.vocab, (B, S)).astype(
            np.int32)
        self.x = rng.normal(size=(B, S, self.tcfg.d_model)).astype(
            np.float32)
        cfg = self.jcfg
        self.forward = jax.jit(lambda p, t: JS.forward(p, t, cfg))
        self.prefill = jax.jit(lambda p, t: JS.prefill(p, t, cfg))
        self.decode = jax.jit(
            lambda p, t, c, pos: JS.decode_step(p, t, c, pos, cfg))


@pytest.fixture(scope="module", params=["gemma2-2b", "stablelm-1.6b"])
def run(request):
    return Run(request.param)


def test_layers_match_repro(run):
    jcfg, tcfg = run.jcfg, run.tcfg
    x = jnp.asarray(run.x)
    tx = torch.from_numpy(run.x)
    np.testing.assert_allclose(
        TL.norm_apply(run.tp["final_norm"], tx, tcfg).numpy(),
        np.asarray(JL.norm_apply(run.jp["final_norm"], x, jcfg)), **TOL)
    qk = run.x.reshape(B, S, 4, 16)
    pos = np.arange(S)[None]
    np.testing.assert_allclose(
        TL.rope(torch.from_numpy(qk), torch.from_numpy(pos), 10000.0,
                tcfg.rope_fraction).numpy(),
        np.asarray(JL.rope(jnp.asarray(qk), jnp.asarray(pos), 10000.0,
                           jcfg.rope_fraction)), **TOL)
    mlp = jax.jit(lambda p, x: JL.mlp_apply(p, x, jcfg))
    for i, kind in enumerate(tcfg.layer_pattern):
        jl = run.jp["layers"][i][0]
        tl = run.tp["layers"][i][0]
        attn = jax.jit(lambda p, x: JL.attn_apply(p, x, jcfg, kind=kind))
        np.testing.assert_allclose(
            TL.attn_apply(tl["mix"], tx, tcfg, kind=kind).numpy(),
            np.asarray(attn(jl["mix"], x)), **TOL, err_msg=kind)
        np.testing.assert_allclose(
            TL.mlp_apply(tl["ffn"], tx, tcfg).numpy(),
            np.asarray(mlp(jl["ffn"], x)), **TOL)


def test_forward_and_cross_entropy_match_repro(run):
    want = run.forward(run.jp, jnp.asarray(run.tokens))
    got = TS.forward(run.tp, torch.from_numpy(run.tokens), run.tcfg)
    assert got.dtype == torch.float32 and got.shape == (B, S,
                                                        run.tcfg.vocab)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)
    labels = np.roll(run.tokens, -1, axis=1)
    labels[:, -3:] = -1
    loss = TLM.cross_entropy(got, torch.from_numpy(labels)).item()
    np.testing.assert_allclose(
        loss, float(JLM.cross_entropy(want, jnp.asarray(labels))), rtol=1e-5)
    batch = {"tokens": torch.from_numpy(run.tokens),
             "labels": torch.from_numpy(labels)}
    assert TLM.loss_fn(run.tp, batch, run.tcfg).item() == loss


def test_prefill_and_decode_match_repro(run):
    """Last logits and every K/V of the prefill, then 8 decode steps
    teacher-forced with repro's greedy tokens from both packages'
    caches (widened by 8, as the launchers do)."""
    jlogits, jcache = run.prefill(run.jp, jnp.asarray(run.tokens))
    step = TLM.make_prefill_step(run.tcfg)
    tlogits, tcache = step(run.tp, {"tokens": torch.from_numpy(
        run.tokens)})
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                               **LOGIT_TOL)
    assert len(tcache) == len(jcache)
    for tc, jc in zip(tcache, jcache):
        for n in ("k", "v"):
            assert tuple(tc[n].shape) == jc[n].shape
            np.testing.assert_allclose(tc[n].numpy(), np.asarray(jc[n]),
                                       **LOGIT_TOL)
    jcache = jax.tree.map(
        lambda a: jnp.pad(a, ((0, 0), (0, 0), (0, STEPS), (0, 0), (0, 0))),
        jcache)
    tcache = TS.widen_cache(tcache, STEPS)
    serve = TLM.make_serve_step(run.tcfg)
    tok = jnp.argmax(jlogits, -1).astype(jnp.int32)[:, None]
    for i in range(STEPS):
        jl, jcache = run.decode(run.jp, tok, jcache, jnp.int32(S + i))
        tl, _ = TS.decode_step(run.tp, torch.from_numpy(np.array(tok)),
                               tcache, S + i, run.tcfg)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL,
                                   err_msg=f"decode step {i}")
        nxt = jnp.argmax(jl, -1).astype(jnp.int32)
        np.testing.assert_array_equal(tl.argmax(-1).numpy(), np.asarray(nxt))
        tok = nxt[:, None]
    # the greedy serve step: the same token from the same cache
    got, _ = serve(run.tp, [dict(c) for c in tcache],
                   torch.from_numpy(np.array(tok)), S + STEPS - 1)
    assert got.dtype == torch.int32 and got.shape == (B,)


def test_masks_and_cache_specs_match_repro():
    for Sq, Sk, off, window in ((5, 9, 4, None), (16, 16, 0, 3),
                                (1, 40, 39, 16)):
        np.testing.assert_array_equal(
            TL.causal_mask(Sq, Sk, off, window).numpy(),
            np.asarray(JL.causal_mask(Sq, Sk, off, window)))
    for arch in ("gemma2-2b", "stablelm-1.6b"):
        jcfg, tcfg = _cfgs(arch)
        want = JL.attn_cache_spec(jcfg, 3, 20)
        for n, t in TL.attn_cache_spec(tcfg, 3, 20).items():
            assert tuple(t.shape) == want[n].shape and not t.any()
        for tc, jc in zip(TS.init_cache(tcfg, 3, 20),
                          JS.init_cache(jcfg, 3, 20)):
            for n, t in tc.items():
                assert tuple(t.shape) == jc[n].shape and not t.any()


def test_unported_blocks_say_so():
    """Cross-attention and encoders, the last blocks the port refused,
    now run: a cross-attention decoder, an encoder-decoder and an
    encoder alone give finite logits (``test_torch_encdec.py`` holds
    them to repro). What still raises: an unknown block kind, and the
    ``cuda`` backend on CPU tensors."""
    base = treduce(tconfigs.get_config("gemma2-2b", dtype="float32"))
    xattn = dataclasses.replace(base, layer_pattern=("attn", "xattn"),
                                xattn_source_len=24)
    tokens = torch.zeros(1, 4, dtype=torch.int64)
    for cfg in (xattn,
                dataclasses.replace(xattn, encoder=dataclasses.replace(
                    base, is_encoder=True)),
                dataclasses.replace(base, is_encoder=True)):
        logits = TS.forward(TS.init_params(TR.key(0), cfg), tokens, cfg,
                            xsource=torch.ones(1, 24, 64))
        assert logits.shape == (1, 4, cfg.vocab)
        assert bool(torch.isfinite(logits).all())
    with pytest.raises(ValueError, match="unknown block kind 'conv'"):
        TS.init_params(TR.key(0), dataclasses.replace(
            base, layer_pattern=("attn", "conv")))
    for arch in tconfigs.ARCHS:
        cfg = treduce(tconfigs.get_config(arch, dtype="float32"))
        TS.init_cache(cfg, 1, 4)
    with pytest.raises(ValueError, match="cuda"):
        _, tcfg = _cfgs("stablelm-1.6b")
        TS.forward({}, torch.zeros(1, 4, dtype=torch.int64), tcfg,
                   backend="cuda")


LAUNCH = ["--workload", "lm", "--arch", "gemma2-2b", "--reduce", "--batch",
          "2", "--prompt-len", "32", "--gen", "8", "--seed", "3"]


def test_launchers_print_the_same_sample(monkeypatch, capsys):
    from repro.launch import serve as jserve
    from repro_torch.launch import serve as tserve
    monkeypatch.setattr(sys, "argv", ["serve"] + LAUNCH)
    jserve.main()
    want = capsys.readouterr().out.splitlines()
    out = tserve.main(LAUNCH + ["--device", "cpu"])
    got = capsys.readouterr().out.splitlines()
    assert got[0].startswith("prefill 2x32 in ") and "tok/s" in got[0]
    assert got[1].startswith("sample: [") and got[1] == want[1]
    assert out["tokens"].shape == (2, 8)
    assert got[1] == f"sample: {out['tokens'][0, :12].tolist()}"
