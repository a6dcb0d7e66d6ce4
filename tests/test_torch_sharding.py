"""``repro_torch.distributed.sharding`` and ``runtime.elastic`` against the
reference on the CPU: ``spec_for`` on every parameter of every
registered arch (the port's per-repeat tensors against the reference's
stacked ones, whose leading repeat dimension gets None); the placements
on a (2, 4) ("data", "model") mesh against ``repro.params_shardings`` on
a ``jax.sharding.AbstractMesh``; then one spawn of 4 gloo ranks repeats
``tests/test_distributed.py::test_elastic_reshard_4_to_2``: a 2-layer LM
placed on a (2, 2) mesh, saved, and resharded from the checkpoint and
from the live DTensors onto (2, 1), a subgroup of the same world.
Tolerance: exact (axis names; the resharded tensors bit for bit). The
reference is imported inside the tests: the spawned ranks import this
module, and need no JAX."""
import tempfile
import types

import pytest
import torch

from repro_torch import configs
from repro_torch.core import rng as TR
from repro_torch.distributed import sharding as sh
from repro_torch.launch.mesh import spawn
from repro_torch.models.transformer import lm, stack

torch.set_num_threads(1)

ARCHS = sorted(configs.ARCHS)
MESH = types.SimpleNamespace(mesh_dim_names=("data", "model"), shape=(2, 4))


def _jax_leaves(tree):
    import jax

    from repro.distributed import sharding as jsh
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {jsh._path_names(p): leaf for p, leaf in flat}


def _pairs(arch, amesh):
    """(port path, port leaf, reference path, reference leaf, stacked,
    the reference's sharding of it on ``amesh``) for every parameter of
    ``arch`` at full width."""
    import jax

    from repro import configs as jconfigs
    from repro.distributed import sharding as jsh
    from repro.models.transformer import stack as jstack

    jcfg = jconfigs.get_config(arch, dtype="bfloat16")
    shapes = jax.eval_shape(
        lambda: jstack.init_params(jax.random.key(0), jcfg))
    jleaves = _jax_leaves(shapes)
    shards = _jax_leaves(jsh.params_shardings(shapes, amesh))
    cfg = configs.get_config(arch, dtype="bfloat16")
    out = []
    for key, t in lm.flatten_params(stack.init_params(
            TR.key(0), cfg, device="meta")).items():
        path = tuple(key.split("/"))
        jpath, stacked = path, False
        if path not in jleaves:   # per-repeat: drop the repeat index
            i = path.index("layers")
            jpath, stacked = path[:i + 2] + path[i + 3:], True
        out.append((path, t, jpath, jleaves[jpath], stacked,
                    shards[jpath]))
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_spec_for_and_placements_match_the_reference(arch):
    """On every leaf: the port's entries are the reference's (less the
    stacked repeat dimension's None), and its placements on the (2, 4)
    mesh are those of ``params_shardings`` on an AbstractMesh."""
    import jax

    from repro.distributed import sharding as jsh
    amesh = jax.sharding.AbstractMesh((2, 4), ("data", "model"))
    for path, t, jpath, jleaf, stacked, shard in _pairs(arch, amesh):
        want = jsh.spec_for(jpath, jleaf)
        got = sh.spec_for(path, t)
        assert ((None,) + got if stacked else got) == tuple(want), path
        jspec = tuple(shard.spec)
        jspec = jspec + (None,) * (jleaf.ndim - len(jspec))
        assert ((None,) + sh.leaf_entries(path, t, MESH) if stacked
                else sh.leaf_entries(path, t, MESH)) == jspec, path
        assert sh.placements(sh.leaf_entries(path, t, MESH), MESH) == \
            _placements(jspec[1:] if stacked else jspec)


def _placements(entries):
    from torch.distributed.tensor import Replicate, Shard
    out = [Replicate(), Replicate()]
    for d, e in enumerate(entries):
        for a in (() if e is None else (e,) if isinstance(e, str) else e):
            out[MESH.mesh_dim_names.index(a)] = Shard(d)
    return tuple(out)


def test_rules_filter_axes_and_replicate_odd_dims():
    pod = types.SimpleNamespace(mesh_dim_names=("pod", "data", "model"),
                                shape=(2, 2, 4))
    w = torch.empty(64, 96, device="meta")
    assert sh.leaf_entries(("layers", "0", "0", "mix", "wq"), w, pod) == \
        (("pod", "data"), "model")
    assert sh.leaf_entries(("layers", "0", "0", "mix", "wq"), w, MESH) == \
        ("data", "model")
    odd = torch.empty(51_866, 8, device="meta")      # whisper's vocabulary
    assert sh.leaf_entries(("embed",), odd, MESH) == (None, "data")
    sh.set_rule_overrides(sh.SEQ_PARALLEL_ATTN_OVERRIDES)
    try:
        assert sh.spec_for(("wq",), w) == (sh.FSDP, None)
    finally:
        sh.set_rule_overrides(None)
    assert sh.constrain_like_params({"w": w}) == {"w": w}


def elastic_rank(mesh, ckpt_dir):
    """One of 4 gloo ranks: repro's 2-layer LM (its test's config) placed
    on (2, 2), saved by rank 0, resharded onto (2, 1) over ranks 0-1 from
    the checkpoint and from the live DTensors; ranks 0-1 compare the
    gathered tensors with the originals."""
    import torch.distributed as dist

    from repro_torch.models.transformer.config import TransformerConfig
    from repro_torch.runtime import checkpoint as ck
    from repro_torch.runtime import elastic

    cfg = TransformerConfig("t", num_layers=2, d_model=32, n_heads=4,
                            n_kv_heads=2, head_dim=8, d_ff=64, vocab=64,
                            dtype="float32", scan_layers=False, remat=False)
    params = stack.init_params(TR.key(0), cfg)
    m4 = sh.make_mesh((2, 2), "cpu")
    p4 = sh.distribute(params, m4)
    whole = sh.full_tensors(p4)
    if dist.get_rank() == 0:
        ck.save(ckpt_dir, 1, {"params": whole})
    dist.barrier()
    m2 = sh.make_mesh((2, 1), "cpu", ranks=[0, 1])
    from_ckpt = elastic.reshard_checkpoint(ckpt_dir, 1, {"params": params},
                                           m2)["params"]
    live = elastic.reshard_live(p4, m2)
    out = {"rank": dist.get_rank()}
    if dist.get_rank() in (0, 1):
        want = lm.flatten_params(params)
        out["placements"] = {k: tuple(t.placements) for k, t in
                             lm.flatten_params(from_ckpt).items()}
        for name, tree in (("checkpoint", from_ckpt), ("live", live)):
            got = lm.flatten_params(sh.full_tensors(tree))
            out[name] = all(torch.equal(got[k], want[k]) for k in want)
        out["wq_local"] = tuple(lm.flatten_params(from_ckpt)[
            "layers/0/0/mix/wq"].to_local().shape)
        out["saved_equal"] = all(torch.equal(a, want[k]) for k, a in
                                 lm.flatten_params(whole).items())
    return out


def test_elastic_reshard_4_to_2():
    with tempfile.TemporaryDirectory() as d:
        out = spawn(elastic_rank, 4, d, device="cpu", timeout_s=120.0)
    assert out["rank"] == 0
    assert out["saved_equal"] and out["checkpoint"] and out["live"]
    from torch.distributed.tensor import Replicate, Shard
    assert out["placements"]["layers/0/0/mix/wq"] == (Shard(0), Shard(1))
    assert out["placements"]["final_norm/scale"] == (Replicate(),
                                                     Replicate())
    assert out["wq_local"] == (16, 32)
