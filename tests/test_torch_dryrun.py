"""``repro_torch.launch.dryrun`` and ``lm.input_specs`` / ``cache_specs``
against the reference on the CPU: for every registered arch at full
width, ``_param_count`` and ``_active_frac`` (the port on the ``meta``
device, the reference through ``jax.eval_shape``; nothing allocated);
every cell's input and cache specs' shapes and dtypes; and
``microbatches_for`` at the reference's 14 GiB and TP 16. Tolerance:
exact for counts, shapes, dtypes and microbatches; the active fraction
to 1e-12 relative (sums in another order)."""
import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models.transformer import lm as jlm
from repro_torch import configs
from repro_torch.launch import dryrun
from repro_torch.models.transformer import lm

torch.set_num_threads(1)

ARCHS = sorted(configs.ARCHS)


def _reference_dryrun():
    """``repro.launch.dryrun`` sets XLA_FLAGS for 512 host devices when
    imported: the backend is started first (so this worker keeps its one
    device) and the variable is put back (so no later subprocess sees
    it)."""
    jax.devices()
    before = os.environ.get("XLA_FLAGS")
    from repro.launch import dryrun as jdry
    if before is None:
        os.environ.pop("XLA_FLAGS", None)
    else:
        os.environ["XLA_FLAGS"] = before
    return jdry


@pytest.fixture(scope="module")
def reference():
    jdry = _reference_dryrun()
    out = {}
    for arch in ARCHS:
        cfg = jconfigs.get_config(arch, dtype="bfloat16")
        out[arch] = (jdry._param_count(cfg), jdry._active_frac(arch, cfg))
    return jdry, out


@pytest.mark.parametrize("arch", ARCHS)
def test_param_count_and_active_fraction(reference, arch):
    _, want = reference
    cfg = configs.get_config(arch, dtype="bfloat16")
    n, frac = want[arch]
    assert dryrun._param_count(cfg) == n
    assert dryrun._active_frac(arch, cfg) == pytest.approx(frac, rel=1e-12)


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, tree


@pytest.mark.parametrize("arch", ARCHS)
def test_input_and_cache_specs(arch):
    jcfg = jconfigs.get_config(arch, dtype="bfloat16")
    cfg = configs.get_config(arch, dtype="bfloat16")
    for cell in configs.cells_for(arch):
        shape = configs.shape_by_name(cell["shape"])
        want = dict(_leaves(jlm.input_specs(jcfg, shape)))
        got = dict(_leaves(lm.input_specs(cfg, shape)))
        assert set(got) == set(want), cell
        for k, t in got.items():
            assert t.device.type == "meta"
            assert tuple(t.shape) == tuple(want[k].shape), (cell, k)
            assert str(t.dtype).split(".")[-1] == str(want[k].dtype), k
        jc = dict(_leaves(jlm.cache_specs(jcfg, shape)))
        tc = dict(_leaves(lm.cache_specs(cfg, shape)))
        assert set(tc) == set(jc), cell
        for k, t in tc.items():
            assert t.device.type == "meta"
            assert tuple(t.shape) == tuple(jc[k].shape), (cell, k)
            assert str(t.dtype).split(".")[-1] == str(jc[k].dtype), k


def test_microbatches_for_matches_the_reference(reference):
    jdry, counts = reference
    for arch in ARCHS:
        jcfg = jconfigs.get_config(arch, dtype="bfloat16")
        cfg = configs.get_config(arch, dtype="bfloat16")
        n = counts[arch][0]
        opt = 2 if arch in dryrun.BIG_ARCHS else 4
        for name in ("train_4k", "prefill_32k"):
            for dp, chips in ((16, 256), (32, 512), (1, 16)):
                jshape = jconfigs.shape_by_name(name)
                want = jdry.microbatches_for(jcfg, jshape, dp, chips=chips,
                                             n_params=n, opt_bytes=opt)
                got = dryrun.microbatches_for(
                    cfg, configs.shape_by_name(name), dp, chips=chips,
                    n_params=n, opt_bytes=opt,
                    budget=dryrun.REPRO_HBM_BUDGET, tp=16)
                assert got == want, (arch, name, dp)


def test_one_card_account():
    """The cells on one card: gemma2-2b's train_4k fits at batch 256 in
    microbatches, its decode_32k cache does not (with the largest batch
    and depth that do), and labor-gcn fits; nothing is allocated."""
    rec = dryrun.run_cell("gemma2-2b", "train_4k", verbose=False)
    acct = rec["account"]
    assert rec["fits"] and rec["microbatches"] > 1
    assert acct["resident"] == acct["params"] + acct["opt_state"]
    assert acct["grads"] == acct["params"]
    assert rec["model_flops"] == 6.0 * rec["params"] * 256 * 4096
    dec = dryrun.run_cell("gemma2-2b", "decode_32k", verbose=False)
    assert not dec["fits"] and 0 < dec["fit_batch"] < 128
    assert dec["account"]["cache"] == 2 * 26 * 128 * 32768 * 4 * 256 * 2
    cut = dryrun.account(dataclasses.replace(
        configs.get_config("gemma2-2b", dtype="bfloat16"),
        num_layers=dec["fit_layers"]), "decode", dec["fit_batch"], 32768)
    assert cut["total"] <= dryrun.CARD_BYTES
    gnn = dryrun.run_cell("labor-gcn", verbose=False)
    assert gnn["fits"] and gnn["roofline"]["dominant"] in (
        "compute", "memory")
    assert np.isfinite(gnn["model_flops_geometry"])
