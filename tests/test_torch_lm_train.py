"""LM training in repro_torch against repro on the CPU, at ``reduce_cfg``
sizes (d 64, 4 heads of 16, vocab 257):

  * ``BigramStream``'s batches bit for bit;
  * ``cosine_schedule`` at steps 0, warmup, between and total, within
    1e-7;
  * Adam with ``lr_scale`` (a float and a schedule's 0-d tensor) and
    with float32 and bfloat16 moments, functional and in place, against
    ``repro.optim.adam`` over 3 steps: parameters to rtol 1e-6, the
    moments to their dtype's rounding;
  * ``make_train_step`` for reduced gemma2-2b and stablelm-1.6b, at 1
    and 2 microbatches (the latter with a cosine schedule), and gemma2-2b
    with remat on in both packages (the port's ``torch.utils.checkpoint``
    per repeat group against repro's ``jax.checkpoint``): the loss and
    every updated parameter after 2 steps within rtol 1e-4 / atol 1e-5,
    but for the entries whose gradient at a step is nonzero and below
    1e-5 of its tensor's largest: the two packages' gradients agree to ~6e-7
    relative L2, so such an entry's gradient is float noise in its last
    digits, and Adam's first steps move an entry by about lr along its
    gradient's sign whatever its size (stablelm-1.6b's embed: a
    gradient of -1.94e-7 in repro, -1.70e-7 here, of a tensor whose
    largest is 0.96, and the entry 6.9e-5 apart after 2 steps); those
    are held to 2 x 2 x lr, the most two steps can move them apart;
  * both ``--workload lm --reduce`` launchers: the same ``first_loss``
    and ``final_loss`` within 1e-4.

repro's train steps run jitted with the config closed over.
"""
import dataclasses
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

from repro import configs as jconfigs  # noqa: E402
from repro.configs.reduce import reduce_cfg as jreduce  # noqa: E402
from repro.data.tokens import BigramStream as JStream  # noqa: E402
from repro.models.transformer import lm as JLM  # noqa: E402
from repro.models.transformer import stack as JS  # noqa: E402
from repro.optim import adam as JA  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.configs.reduce import reduce_cfg as treduce  # noqa: E402
from repro_torch.data.tokens import BigramStream as TStream  # noqa: E402
from repro_torch.models.transformer import lm as TLM  # noqa: E402
from repro_torch.models.transformer import stack as TS  # noqa: E402
from repro_torch.optim import adam as TA  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-5)


def _cfgs(arch, **kw):
    j = jreduce(jconfigs.get_config(arch, dtype="float32"))
    t = treduce(tconfigs.get_config(arch, dtype="float32"))
    return dataclasses.replace(j, **kw), dataclasses.replace(t, **kw)


def _jax_flat(tree, prefix=""):
    """repro's tree by the port's paths (``flatten_params``)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_jax_flat(v, f"{prefix}/{k}" if prefix else k))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for k, v in enumerate(tree):
            out.update(_jax_flat(v, f"{prefix}/{k}" if prefix else str(k)))
        return out
    return {prefix: np.asarray(tree)}


@pytest.mark.parametrize("vocab,seed,branching", [(257, 3, 4), (50280, 0, 4),
                                                  (32000, 7, 2)])
def test_bigram_stream_is_bit_exact(vocab, seed, branching):
    js, ts = JStream(vocab, seed, branching), TStream(vocab, seed, branching)
    np.testing.assert_array_equal(ts.next_tok, js.next_tok)
    for bs, sl in ((4, 64), (1, 1), (3, 200)):
        jt, jl = js.batch(bs, sl)
        tt, tl = ts.batch(bs, sl)
        assert tt.dtype == tl.dtype == torch.int32
        np.testing.assert_array_equal(tt.numpy(), jt)
        np.testing.assert_array_equal(tl.numpy(), jl)
    tt, _ = next(ts.batches(2, 8))
    np.testing.assert_array_equal(tt.numpy(), next(js.batches(2, 8))[0])


@pytest.mark.parametrize("warmup,total,floor", [(10, 100, 0.1), (0, 7, 0.0),
                                                (5, 5, 0.3)])
def test_cosine_schedule_matches_repro(warmup, total, floor):
    js = JA.cosine_schedule(1e-3, warmup, total, floor)
    ts = TA.cosine_schedule(1e-3, warmup, total, floor)
    for s in sorted({0, warmup, (warmup + total) // 2, total, total + 3}):
        got = ts(torch.tensor(s, dtype=torch.int32))
        assert got.dtype == torch.float32 and got.dim() == 0
        np.testing.assert_allclose(got.item(),
                                   float(js(jnp.asarray(s, jnp.int32))),
                                   rtol=0, atol=1e-7, err_msg=str(s))


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("schedule", [False, True])
def test_adam_lr_scale_and_state_dtype_match_repro(state_dtype, schedule):
    rng = np.random.default_rng(5)
    shapes = {"w": (7, 5), "b": (5,), "e": (11, 3)}
    params = {k: rng.normal(size=s).astype(np.float32)
              for k, s in shapes.items()}
    cfg_kw = dict(lr=3e-2, weight_decay=0.01, grad_clip=0.5,
                  state_dtype=state_dtype)
    jcfg, tcfg = JA.AdamConfig(**cfg_kw), TA.AdamConfig(**cfg_kw)
    jsched = JA.cosine_schedule(1e-3, 1, 4)
    tsched = TA.cosine_schedule(1e-3, 1, 4)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jo = JA.init_state(jp, jcfg)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    to = TA.init_state(tp, tcfg)
    ip = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    io = TA.init_state(ip, tcfg)
    sdt = torch.bfloat16 if state_dtype == "bfloat16" else torch.float32
    assert all(m.dtype == sdt for m in to["mu"].values())
    for step in range(3):
        grads = {k: rng.normal(size=s).astype(np.float32)
                 for k, s in shapes.items()}
        js = jsched(jo["step"]) if schedule else 1.0
        ts = tsched(to["step"]) if schedule else 1.0
        jp, jo, jm = JA.apply_updates(
            jp, {k: jnp.asarray(g) for k, g in grads.items()}, jo, jcfg, js)
        tp, to, tm = TA.apply_updates(
            tp, {k: torch.from_numpy(g) for k, g in grads.items()}, to,
            tcfg, ts)
        ip, io, im = TA.apply_updates_(
            ip, {k: torch.from_numpy(g) for k, g in grads.items()}, io,
            tcfg, tsched(io["step"]) if schedule else 1.0)
        for m in (tm, im):
            np.testing.assert_allclose(m["grad_norm"].item(),
                                       float(jm["grad_norm"]), rtol=1e-6)
        for k in shapes:
            for got in (tp[k], ip[k]):
                np.testing.assert_allclose(got.numpy(), np.asarray(jp[k]),
                                           rtol=1e-6, atol=1e-7,
                                           err_msg=f"{k} step {step}")
            for n in ("mu", "nu"):
                want = np.asarray(jo[n][k].astype(jnp.float32))
                for st in (to, io):
                    assert st[n][k].dtype == sdt
                    # bf16 moments: the same float32 value may round to
                    # the neighbouring bf16 after a last-bit difference
                    np.testing.assert_allclose(
                        st[n][k].float().numpy(), want,
                        rtol=1e-2 if sdt == torch.bfloat16 else 1e-6,
                        atol=1e-12)
        assert int(to["step"]) == int(io["step"]) == int(jo["step"])


class Train:
    """Two train steps of one reduced arch in both packages from repro's
    parameters, on the same bigram batches."""

    def __init__(self, arch, n_mb, remat=False):
        self.jcfg, self.tcfg = _cfgs(arch, remat=remat)
        # the launchers' lr: Adam moves an entry by about lr times its
        # gradient's sign, which float noise decides for a gradient near
        # 0 (one such entry of 6,144 moved 3e-5 apart at lr 1e-2)
        opt = dict(lr=1e-3)
        jopt, topt = JA.AdamConfig(**opt), TA.AdamConfig(**opt)
        sched = (lambda lib: lib.cosine_schedule(1e-3, 1, 4)) \
            if n_mb > 1 else (lambda lib: None)
        jp = JS.init_params(jax.random.key(4), self.jcfg)
        self.tp = TS.params_from_jax(jax.tree.map(np.asarray, jp), self.tcfg)
        self.tp0 = {k: t.clone()
                    for k, t in TLM.flatten_params(self.tp).items()}
        jo = JA.init_state(jp, jopt)
        to = TLM.init_opt_state(self.tp, topt)
        jstep = jax.jit(JLM.make_train_step(self.jcfg, jopt, sched(JA),
                                            num_microbatches=n_mb))
        tstep = TLM.make_train_step(self.tcfg, topt, sched(TA),
                                    num_microbatches=n_mb)
        grad_fn = TLM.make_grad_fn(self.tcfg, num_microbatches=n_mb)
        stream = TStream(self.tcfg.vocab, seed=6)
        self.jloss, self.tloss, self.noise = [], [], {}
        for _ in range(2):
            toks, labels = stream.batch(4, 32)
            _, grads = grad_fn(self.tp, {"tokens": toks, "labels": labels})
            for k, g in grads.items():
                small = ((g != 0) & (g.abs() < 1e-5 * g.abs().max())).numpy()
                self.noise[k] = self.noise.get(k, False) | small
            jp, jo, jm = jstep(jp, jo, {"tokens": jnp.asarray(toks.numpy()),
                                        "labels": jnp.asarray(labels.numpy())})
            self.tp, to, tm = tstep(self.tp, to, {"tokens": toks,
                                                  "labels": labels})
            self.jloss.append(float(jm["loss"]))
            self.tloss.append(tm["loss"].item())
            self.grad_norms = (float(jm["grad_norm"]),
                               tm["grad_norm"].item())
        self.jp = _jax_flat(jp)
        self.to = to
        self.lr = opt["lr"]


@pytest.fixture(scope="module",
                params=[("gemma2-2b", 1), ("gemma2-2b", 2),
                        ("stablelm-1.6b", 1), ("stablelm-1.6b", 2),
                        ("gemma2-2b", 1, True)],
                ids=lambda p: (f"{p[0]}-mb{p[1]}"
                               + ("-remat" if p[2:] else "")))
def train(request):
    return Train(*request.param)


def test_train_step_matches_repro(train):
    """The loss of each step, the gradient norm and every parameter
    after 2 steps (entries of a noise-sized gradient to 2 x 2 x lr); the
    state's step count; the parameters moved."""
    np.testing.assert_allclose(train.tloss, train.jloss, **TOL)
    np.testing.assert_allclose(*train.grad_norms[::-1], **TOL)
    got = TLM.flatten_params(train.tp)
    assert sorted(got) == sorted(train.jp)
    n_noise = sum(int(m.sum()) for m in train.noise.values())
    assert n_noise <= 1e-3 * sum(t.numel() for t in got.values())
    for path, want in train.jp.items():
        g, noise = got[path].numpy(), train.noise[path]
        np.testing.assert_allclose(g[~noise], want[~noise], **TOL,
                                   err_msg=path)
        assert np.all(np.abs(g - want)[noise] <= 4 * train.lr), path
        assert not torch.equal(got[path], train.tp0[path]) or \
            path.endswith("bias"), path
    assert int(train.to["step"]) == 2


def test_flatten_round_trip():
    _, tcfg = _cfgs("zamba2-2.7b")
    from repro_torch.core import rng as TR
    params = TS.init_params(TR.key(0), tcfg)
    flat = TLM.flatten_params(params)
    assert "shared/attn/wq" in flat and "layers/5/0/ffn/wi" in flat
    assert not any(p.startswith("layers/5/0/mix") for p in flat)
    back = TLM.unflatten_params(flat, params)
    assert back["layers"][5][0]["mix"] == {}
    assert back["shared"]["mlp"]["wo"] is params["shared"]["mlp"]["wo"]


LAUNCH = ["--workload", "lm", "--arch", "gemma2-2b", "--reduce", "--steps",
          "12", "--batch", "2", "--seq", "32", "--seed", "1"]


def test_lm_launchers_print_the_same_losses(monkeypatch, capsys):
    from repro.launch import train as jtrain
    from repro_torch.launch import train as ttrain
    monkeypatch.setattr(sys, "argv", ["train"] + LAUNCH)
    jtrain.main()
    want = capsys.readouterr().out.splitlines()
    out = ttrain.main(LAUNCH + ["--device", "cpu"])
    got = capsys.readouterr().out.splitlines()
    assert got[0].startswith("step 10 loss ")
    np.testing.assert_allclose(float(got[0].split()[-1]),
                               float(want[0].split()[-1]), rtol=1e-4)
    jrep, trep = json.loads(want[-1]), json.loads(got[-1])
    assert set(trep) == set(jrep) == {"first_loss", "final_loss"}
    assert out == trep
    for k in jrep:
        np.testing.assert_allclose(trep[k], jrep[k], rtol=1e-4, err_msg=k)
