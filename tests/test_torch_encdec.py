"""Cross-attention and encoder-decoder stacks in repro_torch against repro
on the CPU, at reduced sizes (d 64, heads of 16, vocab 257, 24 source
frames, B = 2, a 9-token prompt), in two configs:

  * ``whisper``: whisper's shape (an ``is_encoder`` encoder of 2 layers
    ``("attn",)``, MHA 4 x 16; a decoder of ``("attn", "xattn")`` x 2
    with mixers ``("none", "mlp")``, GQA 4/2, so cross-attention groups
    its heads; ``qkv_bias``, layernorm, gelu, a non-gated MLP, tied
    embeddings);
  * ``vlm``: cross-attention with no encoder, its source 32 wide (not
    ``d_model``), ``qkv_bias``, rmsnorm, a gated silu MLP after every
    block.

For each:

  * ``init_params`` from one key bit for bit, the encoder's subtree
    included (``test_torch_lm.py`` covers the ``split`` key schedule of
    ``scan_layers=True``, which the encoder's tree shares), and
    ``params_from_jax`` of both of repro's layouts (per-repeat lists,
    and each entry's leaves stacked over the repeats);
  * with repro's parameters: ``encode``, ``forward`` logits, the
    prefill's last logits and every cache tensor (``k``, ``v``, ``xk``,
    ``xv``), then 3 teacher-forced ``decode_step``s with repro's greedy
    tokens, all within rtol 1e-5 / atol 1e-5;
  * with ``bk = bv = 0.3`` set through ``params_from_jax``: the port's
    decode equals repro's (ROADMAP C6: both prefills cache the cross
    K/V without the biases, the port on purpose), and both differ from
    their own forward at that position; ``widen_cache`` leaves the
    cross K/V alone when the source is as long as the prompt (repro's
    launcher pads them, C6 (b));
  * the loss and every gradient of step 0 (rtol 1e-4 / atol 1e-6 of
    the largest; the encoder's unused token embedding gets a zero
    gradient in both), 2 microbatches against 1 (1e-5), and 2 Adam
    steps (repro's ``value_and_grad`` of ``loss_fn`` and
    ``adam.apply_updates``, its train step at 1 microbatch): the loss
    and every parameter, rtol 1e-4 / atol 1e-5, but for the
    entries whose gradient at a step is noise: nonzero and below 1e-5
    of its tensor's largest (``test_torch_lm_train.py`` says why; at
    most 1e-3 of all the entries may rest on this outside the bound, as
    in ``test_torch_moe.py``), or in a cross-attention block's ``bk``,
    whose gradient is 0 in exact arithmetic (with no rotary, bk shifts
    all of a query's keys alike, which leaves the softmax as it is) and
    so ~1e-9 of rounding noise in both packages; those move by about lr
    along the noise's sign and are held to 2 x 2 x lr;
  * (whisper) both serve launchers' ``sample:`` tokens and both train
    launchers' losses, on a config patched into both registries;
  * ROADMAP C7: zero frames (the train launchers' default) overflow the
    gradient of a layernorm encoder of 8 layers; ``train_lm(frames=)``.

repro's functions run jitted with the config closed over.
"""
import dataclasses
import functools
import json
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs in parallel workers, and torch's
# OpenMP threads spinning against them slow every worker several-fold
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models.transformer import config as JC  # noqa: E402
from repro.models.transformer import lm as JLM  # noqa: E402
from repro.models.transformer import stack as JS  # noqa: E402
from repro.optim import adam as JA  # noqa: E402
from repro_torch.core import rng as TR  # noqa: E402
from repro_torch.models.transformer import config as TC  # noqa: E402
from repro_torch.models.transformer import lm as TLM  # noqa: E402
from repro_torch.models.transformer import stack as TS  # noqa: E402
from repro_torch.optim import adam as TA  # noqa: E402

B, P, SX, STEPS = 2, 9, 24, 3
TOL = dict(rtol=1e-5, atol=1e-5)
TRAIN_TOL = dict(rtol=1e-4, atol=1e-5)
LR = 1e-3


def _whisper(C, **kw):
    common = dict(d_model=64, n_heads=4, head_dim=16, d_ff=96, vocab=257,
                  qkv_bias=True, norm="layernorm", activation="gelu",
                  gated_mlp=False, dtype="float32", remat=False, **kw)
    enc = C.TransformerConfig(name="whisper-enc", num_layers=2, n_kv_heads=4,
                              layer_pattern=("attn",), is_encoder=True,
                              **common)
    return C.TransformerConfig(
        name="whisper-test", num_layers=4, n_kv_heads=2,
        layer_pattern=("attn", "xattn"), mixers=("none", "mlp"),
        encoder=enc, xattn_source_len=SX, xattn_source_dim=64, **common)


def _vlm(C, **kw):
    return C.TransformerConfig(
        name="vlm-test", num_layers=4, d_model=64, n_heads=4, n_kv_heads=4,
        head_dim=16, d_ff=96, vocab=257, layer_pattern=("attn", "xattn"),
        xattn_source_len=SX, xattn_source_dim=32, qkv_bias=True,
        dtype="float32", remat=False, **kw)


CONFIGS = {"whisper": _whisper, "vlm": _vlm}


def _cfgs(name, scan=False):
    return (CONFIGS[name](JC, scan_layers=scan),
            CONFIGS[name](TC, scan_layers=scan))


@functools.lru_cache(maxsize=None)
def _jax_init(name):
    """repro's ``init_params(key(7))`` of a config, made once (eager,
    ~5 s for whisper's)."""
    return JS.init_params(jax.random.key(7), _cfgs(name)[0])


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _jax_flat(tree, cfg, prefix=""):
    """repro's tree (either layout) by the port's paths, per repeat."""
    out = {}
    for k, v in tree.items():
        path = f"{prefix}{k}"
        if k == "encoder":
            out.update(_jax_flat(v, cfg.encoder, f"{path}/"))
        elif k == "layers":
            for i, entry in enumerate(v):
                for r in range(cfg.repeats):
                    p = (entry[r] if isinstance(entry, list)
                         else jax.tree.map(lambda a: a[r], entry))
                    out.update(_leaves(p, f"{path}/{i}/{r}"))
        else:
            out.update(_leaves(v, path))
    return out


def _leaves(tree, prefix):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}/{k}"))
        return out
    return {prefix: np.asarray(tree)}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_init_params_is_bit_exact(name):
    jcfg, tcfg = _cfgs(name)
    want = _jax_flat(_jax_init(name), jcfg)
    got = {k: t.numpy() for k, t in TLM.flatten_params(
        TS.init_params(TR.key(7), tcfg)).items()}
    assert sorted(got) == sorted(want)
    assert any(k.startswith("encoder/layers/") for k in got) == \
        (name == "whisper")
    for path, w in want.items():
        g = got[path]
        assert g.dtype == w.dtype and g.shape == w.shape, path
        np.testing.assert_array_equal(g.view(np.int32), w.view(np.int32),
                                      err_msg=path)
    if name == "vlm":   # the cross block's K/V take the source's width
        assert got["layers/1/0/mix/wk"].shape == (32, 64)
        assert got["layers/0/0/mix/wk"].shape == (64, 64)


def _stacked(tree):
    """repro's ``scan_layers=True`` layout of a per-repeat tree: each
    pattern entry's leaves stacked over the repeats (the encoder's
    too)."""
    out = {k: v for k, v in tree.items() if k not in ("layers", "encoder")}
    out["layers"] = [jax.tree.map(lambda *a: np.stack(a), *entry)
                     for entry in tree["layers"]]
    if "encoder" in tree:
        out["encoder"] = _stacked(tree["encoder"])
    return out


@pytest.mark.parametrize("name", list(CONFIGS))
def test_params_from_jax_takes_both_layouts(name):
    """The per-repeat lists and the stacked tree give the same tensors,
    the encoder's included."""
    jcfg, tcfg = _cfgs(name)
    jp = _np_tree(_jax_init(name))
    want = _jax_flat(jp, jcfg)
    stacked = _stacked(jp)
    assert not isinstance(stacked["layers"][0], list)
    assert _jax_flat(stacked, jcfg).keys() == want.keys()
    for tree in (jp, stacked):
        got = TLM.flatten_params(TS.params_from_jax(tree, tcfg))
        assert sorted(got) == sorted(want)
        for path, t in got.items():
            np.testing.assert_array_equal(t.numpy(), want[path],
                                          err_msg=path)


def _with_kv_bias(jp, value):
    """repro's parameters with every attention block's bk and bv set."""
    def walk(tree):
        if isinstance(tree, dict):
            return {k: (jnp.full_like(v, value) if k in ("bk", "bv")
                        else walk(v)) for k, v in tree.items()}
        if isinstance(tree, list):
            return [walk(v) for v in tree]
        return tree
    return walk(jp)


class Run:
    """One config in both packages from repro's parameters: repro's
    jitted encode / forward / prefill / decode, its gradients at step 0
    and 2 Adam steps at 2 microbatches, on shared inputs."""

    def __init__(self, name):
        self.name = name
        self.jcfg, self.tcfg = jcfg, tcfg = _cfgs(name)
        self.jp = _jax_init(name)
        self.tp = TS.params_from_jax(_np_tree(self.jp), tcfg)
        rng = np.random.default_rng(2)
        self.tokens = rng.integers(0, tcfg.vocab, (B, P + STEPS)).astype(
            np.int32)
        width = 64 if name == "whisper" else 32
        self.xsource = rng.normal(size=(B, SX, width)).astype(np.float32)
        xs = jnp.asarray(self.xsource)
        self.forward = jax.jit(lambda p, t: JS.forward(p, t, jcfg,
                                                       xsource=xs))
        self.prefill = jax.jit(lambda p, t: JS.prefill(p, t, jcfg,
                                                       xsource=xs))
        self.decode = jax.jit(
            lambda p, t, c, pos: JS.decode_step(p, t, c, pos, jcfg))
        if name == "whisper":
            self.encoded = np.asarray(jax.jit(
                lambda p: JS.encode(p["encoder"], xs, jcfg.encoder))(
                    self.jp))
        self.logits = np.asarray(self.forward(self.jp,
                                              jnp.asarray(self.tokens)))
        self.last, self.cache, self.decoded = self._serve(self.jp)
        # C6: nonzero cross biases
        self.jp_b = _with_kv_bias(self.jp, 0.3)
        self.logits_b = np.asarray(self.forward(
            self.jp_b, jnp.asarray(self.tokens)))
        _, _, self.decoded_b = self._serve(self.jp_b)
        self._train()

    def _serve(self, jp):
        last, cache = self.prefill(jp, jnp.asarray(self.tokens[:, :P]))
        cache_np = _np_tree(cache)
        cache = jax.tree.map(
            lambda a: (jnp.pad(a, ((0, 0), (0, 0), (0, STEPS), (0, 0),
                                   (0, 0))) if a.shape[2] == P else a),
            cache)
        out = []
        for i in range(STEPS):
            tok = jnp.asarray(self.tokens[:, P + i:P + i + 1])
            logits, cache = self.decode(jp, tok, cache, jnp.int32(P + i))
            out.append(np.asarray(logits))
        return np.asarray(last), cache_np, out

    def _train(self):
        """repro's step at 1 microbatch (``make_train_step``'s
        ``value_and_grad`` of ``loss_fn``, then ``adam.apply_updates``)
        twice, on windows of P + 2 tokens; step 0's loss and gradients
        kept."""
        jcfg = self.jcfg
        labels = np.roll(self.tokens, -1, axis=1)
        labels[:, -2:] = -1
        self.labels = labels
        grad = jax.jit(jax.value_and_grad(
            lambda p, b: JLM.loss_fn(p, b, jcfg)))
        jopt = JA.AdamConfig(lr=LR)
        adam = jax.jit(lambda p, g, o: JA.apply_updates(p, g, o, jopt))
        jp, jo = self.jp, JA.init_state(self.jp, jopt)
        self.jlosses = []
        for step in range(2):
            loss, g = grad(jp, _window(self, step, jnp.asarray))
            if step == 0:
                self.jgrads = _jax_flat(g, jcfg)
            jp, jo, _ = adam(jp, g, jo)
            self.jlosses.append(float(loss))
        self.jtrained = _jax_flat(jp, jcfg)


def _window(run, step, conv):
    """The train batch of step ``step``: P + 2 tokens from ``step``."""
    sl = slice(step, step + P + 2)
    return {"tokens": conv(run.tokens[:, sl]),
            "labels": conv(run.labels[:, sl]), "xsource": conv(run.xsource)}


@pytest.fixture(scope="module", params=list(CONFIGS))
def run(request):
    return Run(request.param)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def test_encode_and_forward_match_repro(run):
    tcfg = run.tcfg
    xs = _t(run.xsource)
    if run.name == "whisper":
        enc = TS.encode(run.tp["encoder"], xs, tcfg.encoder)
        assert enc.shape == (B, SX, 64)
        np.testing.assert_allclose(enc.numpy(), run.encoded, **TOL)
    else:   # no encoder: the source is the cross-attention's K/V input
        assert TS._resolve_xsource(run.tp, tcfg, xs) is xs
    got = TS.forward(run.tp, _t(run.tokens), tcfg, xsource=xs)
    assert got.shape == (B, P + STEPS, tcfg.vocab)
    np.testing.assert_allclose(got.numpy(), run.logits, **TOL)
    with pytest.raises(ValueError, match="xsource"):
        TS.forward(run.tp, _t(run.tokens), tcfg)


def _port_serve(run, tp):
    step = TLM.make_prefill_step(run.tcfg)
    last, cache = step(tp, {"tokens": _t(run.tokens[:, :P]),
                            "xsource": _t(run.xsource)})
    cache_0 = [{n: t.clone() for n, t in c.items()} for c in cache]
    cache = TS.widen_cache(cache, STEPS)
    out = []
    for i in range(STEPS):
        logits, cache = TS.decode_step(tp, _t(run.tokens[:, P + i:P + i + 1]),
                                       cache, P + i, run.tcfg)
        out.append(logits.numpy())
    return last, cache_0, out


def test_prefill_and_decode_match_repro(run):
    """Last logits and every cache tensor of the prefill (the cross K/V
    of (repeats, B, 24, Hkv, hd)), then 3 decode steps teacher-forced
    with the prompt's next tokens."""
    last, cache, decoded = _port_serve(run, run.tp)
    np.testing.assert_allclose(last.numpy(), run.last, **TOL)
    assert [sorted(c) for c in cache] == [sorted(c) for c in run.cache] == \
        [["k", "v"], ["xk", "xv"]]
    for i, (tc, jc) in enumerate(zip(cache, run.cache)):
        for n, want in jc.items():
            assert tuple(tc[n].shape) == want.shape, (i, n)
            np.testing.assert_allclose(tc[n].numpy(), want, **TOL,
                                       err_msg=f"entry {i} {n}")
    assert cache[1]["xk"].shape == (2, B, SX, run.tcfg.n_kv_heads, 16)
    for i, (got, want) in enumerate(zip(decoded, run.decoded)):
        np.testing.assert_allclose(got, want, **TOL,
                                   err_msg=f"decode step {i}")
        np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    # teacher-forced decode is the forward at the same positions
    np.testing.assert_allclose(np.stack(decoded, 1),
                               run.logits[:, P:], rtol=1e-4, atol=1e-5)


def test_cross_cache_without_biases_mirrors_repro(run):
    """C6 (a): with nonzero bk/bv both prefills cache the cross K/V
    without them, so the decode differs from the forward in both
    packages by the same amount. C6 (b): the cross K/V keep their
    length when the source is as long as the prompt."""
    tp = TS.params_from_jax(_np_tree(run.jp_b), run.tcfg)
    got = TS.forward(tp, _t(run.tokens), run.tcfg,
                     xsource=_t(run.xsource)).numpy()
    np.testing.assert_allclose(got, run.logits_b, **TOL)
    _, _, decoded = _port_serve(run, tp)
    for i, (g, w) in enumerate(zip(decoded, run.decoded_b)):
        np.testing.assert_allclose(g, w, **TOL, err_msg=f"decode step {i}")
        for d, f in ((g, got), (w, run.logits_b)):
            assert np.abs(d - f[:, P + i]).max() > 1e-2, i
    cache = TS.init_cache(run.tcfg, B, SX)
    wide = TS.widen_cache(cache, 5)
    assert wide[0]["k"].shape[2] == SX + 5
    assert wide[1]["xk"].shape[2] == SX


def test_train_steps_match_repro(run):
    """Step 0's loss and every gradient, the encoder's included; 2
    microbatches (``xsource`` split along the batch like the tokens)
    against 1; then 2 Adam steps: the loss of each and every parameter
    after them."""
    topt = TA.AdamConfig(lr=LR)
    tp = TS.params_from_jax(_np_tree(run.jp), run.tcfg)
    tp0 = {k: t.clone() for k, t in TLM.flatten_params(tp).items()}
    opt = TLM.init_opt_state(tp, topt)
    step = TLM.make_train_step(run.tcfg, topt)
    grad_fn = TLM.make_grad_fn(run.tcfg)
    losses, noise = [], {}
    zero = _cross_bk(run.tcfg)
    for s in range(2):
        batch = _window(run, s, _t)
        loss, grads = grad_fn(tp, batch)
        if s == 0:
            _check_grads(run, loss, grads, TLM.make_grad_fn(
                run.tcfg, num_microbatches=2)(tp, batch))
        for k, g in grads.items():
            small = ((g != 0) & (g.abs() < 1e-5 * g.abs().max())).numpy()
            if k in zero:
                small = np.ones_like(small)
            noise[k] = noise.get(k, False) | small
        tp, opt, m = step(tp, opt, batch)
        losses.append(m["loss"].item())
    np.testing.assert_allclose(losses, run.jlosses, **TRAIN_TOL)
    got = TLM.flatten_params(tp)
    assert sorted(got) == sorted(run.jtrained)
    resting = 0
    for path, want in run.jtrained.items():
        g, mask = got[path].numpy(), noise[path]
        np.testing.assert_allclose(g[~mask], want[~mask], **TRAIN_TOL,
                                   err_msg=path)
        assert np.all(np.abs(g - want)[mask] <= 4 * LR), path
        if path not in zero:
            outside = np.abs(g - want) > (TRAIN_TOL["atol"]
                                          + TRAIN_TOL["rtol"] * np.abs(want))
            resting += int((outside & mask).sum())
        moved = not torch.equal(got[path], tp0[path])
        assert moved or path == "encoder/embed", path
    # the small-gradient exemption carries at most 1e-3 of the entries
    assert resting <= 1e-3 * sum(t.numel() for t in got.values())
    assert int(opt["step"]) == 2


def _cross_bk(cfg):
    """The paths of the cross-attention blocks' ``bk``: no rotary, so bk
    shifts every key of a query alike and its gradient is 0 in exact
    arithmetic."""
    return {f"layers/{i}/{r}/mix/bk" for i, kind in
            enumerate(cfg.layer_pattern) if kind == "xattn"
            for r in range(cfg.repeats)}


def _check_grads(run, loss, grads, mb2):
    np.testing.assert_allclose(loss.item(), run.jlosses[0], rtol=1e-5)
    assert sorted(grads) == sorted(run.jgrads) == sorted(mb2[1])
    np.testing.assert_allclose(mb2[0].item(), loss.item(), rtol=1e-5)
    scale = max(np.abs(g).max() for g in run.jgrads.values())
    for path, want in run.jgrads.items():
        np.testing.assert_allclose(grads[path].numpy(), want, rtol=1e-4,
                                   atol=1e-6 * scale, err_msg=path)
        np.testing.assert_allclose(mb2[1][path].numpy(),
                                   grads[path].numpy(), rtol=1e-5,
                                   atol=1e-7 * scale, err_msg=path)
    if run.name == "whisper":
        # the encoder's token embedding is never read: a zero gradient
        assert not grads["encoder/embed"].any()
        assert not run.jgrads["encoder/embed"].any()
        assert any(grads[k].abs().max() > 0 for k in grads
                   if k.startswith("encoder/layers/"))


SERVE = ["--workload", "lm", "--arch", "whisper-test", "--batch", "2",
         "--prompt-len", "9", "--gen", "4", "--seed", "3"]
TRAIN = ["--workload", "lm", "--arch", "whisper-test", "--steps", "10",
         "--batch", "2", "--seq", "16", "--seed", "1"]


def test_launchers_match_repro(monkeypatch, capsys):
    """Both serve launchers print the same sample tokens (the source from
    normal(key(seed)), a 9-token prompt against 24 frames) and both
    train launchers the same losses (zero frames), on the whisper
    config patched into both registries (repro's prefill jitted)."""
    import repro.configs as jreg
    import repro_torch.configs as treg
    from repro.launch import serve as jserve
    from repro.launch import train as jtrain
    from repro_torch.launch import serve as tserve
    from repro_torch.launch import train as ttrain

    jcfg, tcfg = _cfgs("whisper")
    monkeypatch.setattr(jreg, "get_config", lambda arch, **kw: jcfg)
    monkeypatch.setattr(treg, "get_config", lambda arch, **kw: tcfg)
    # repro's launcher prefills op by op (~8 s); jitted it is ~2 s
    monkeypatch.setattr(JS, "prefill", jax.jit(JS.prefill,
                                               static_argnums=(2,)))
    monkeypatch.setattr(sys, "argv", ["serve"] + SERVE)
    jserve.main()
    want = capsys.readouterr().out.splitlines()
    out = tserve.main(SERVE + ["--device", "cpu"])
    got = capsys.readouterr().out.splitlines()
    assert got[0].startswith("prefill 2x9 in ")
    assert got[1].startswith("sample: [") and got[1] == want[1]
    assert out["tokens"].shape == (2, 4)
    assert out["cache"][1]["xk"].shape == (2, 2, SX, 2, 16)

    monkeypatch.setattr(sys, "argv", ["train"] + TRAIN)
    jtrain.main()
    want = capsys.readouterr().out.splitlines()
    rep = ttrain.main(TRAIN + ["--device", "cpu"])
    got = capsys.readouterr().out.splitlines()
    assert got[0].startswith("step 10 loss ")
    jrep = json.loads(want[-1])
    assert json.loads(got[-1]) == rep
    for k in jrep:
        np.testing.assert_allclose(rep[k], jrep[k], rtol=1e-4, err_msg=k)


def test_zero_frames_overflow_a_deep_encoder():
    """ROADMAP C7: the train launchers' default source is zero frames
    (repro's), and a zero row's layernorm scales its gradient by
    1/sqrt(eps) = 1000, once a norm: the whisper config's gradient norm
    is ~3e10 with its 2 encoder layers and NaN with 8, so a run's
    parameters go NaN on its first update (repro's too: its gradient is
    NaN at 8 and 16 layers). ``train_lm(frames=...)`` trains on given
    frames instead, and stays finite."""
    from repro_torch.launch import train as ttrain
    _, tcfg = _cfgs("whisper")
    deep = dataclasses.replace(tcfg, encoder=dataclasses.replace(
        tcfg.encoder, num_layers=8))
    args = ttrain.parser().parse_args(
        ["--workload", "lm", "--device", "cpu", "--steps", "2", "--batch",
         "2", "--seq", "16", "--seed", "1"])
    frames = TR.normal(TR.key(5), (2, SX, 64))
    for cfg, finite in ((tcfg, True), (deep, False)):
        params = TS.init_params(TR.key(0), cfg)
        batch = {"tokens": torch.zeros(2, 16, dtype=torch.int32),
                 "labels": torch.ones(2, 16, dtype=torch.int32)}
        for xs, ok in ((torch.zeros(2, SX, 64), finite), (frames, True)):
            _, grads = TLM.make_grad_fn(cfg)(params, {**batch,
                                                      "xsource": xs})
            norm = TA.global_norm(grads).item()
            assert np.isfinite(norm) == ok, (cfg.encoder.num_layers, norm)
            if ok and xs is not frames:
                assert norm > 1e9
    run = ttrain.train_lm(args, (deep, TS.init_params(TR.key(0), deep)))
    assert not np.isfinite(run["final_loss"])
    run = ttrain.train_lm(args, (deep, TS.init_params(TR.key(0), deep)),
                          frames=frames)
    assert all(np.isfinite(run["losses"]))
