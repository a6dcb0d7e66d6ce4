"""``repro_torch.launch.perf`` on the CPU against the reference: on a
products graph at scale 0.004, ``measure_gnn`` runs labor-gcn's step
(LABOR-0, fanouts 10,10,10, the mesh's cap geometry, batch 64) and its
per-layer live sizes |V^l|, |E^l|, the expanded edges and the caps, and
so its counted work, equal those of the reference's blocks sampled with
the same seeds and key; ``model_flops_geometry`` is the reference's
formula (``src/repro/launch/dryrun.py:195-204``, restated below); every
time field is None on the CPU; ``perf.main`` exits non-zero without a
card; ``measure_lm``'s parameter count and model FLOPs are the
reference's. Tolerance: exact (integers, and floats from the same
integers)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import samplers as JS
from repro.graph.generators import paper_dataset as jds
from repro_torch.core import rng as TR
from repro_torch.data.gnn_loader import SeedBatches
from repro_torch.graph.generators import paper_dataset as tds
from repro_torch.launch import dryrun, perf

torch.set_num_threads(1)

B = 64


@pytest.fixture(scope="module")
def runs():
    dt = tds("products", 0.004, seed=0)
    seeds = SeedBatches(dt.train_idx, B, seed=0).at(0).numpy()
    key = TR.fold_in(TR.key(1), 0)
    got = perf.measure_gnn("labor-0", device="cpu", dataset=dt,
                           global_batch=B, batches=[(seeds, key)],
                           keep=True)
    dj = jds("products", 0.004, seed=0)
    g = dj.graph
    avg = g.num_edges / g.num_vertices
    sj = JS.from_graph_stats(
        "labor-0", batch_size=B, fanouts=(10, 10, 10), avg_degree=avg,
        max_degree=int(min(avg * 64, g.num_vertices - 1)),
        num_vertices=g.num_vertices, num_edges=int(g.num_vertices * avg),
        safety=1.6)
    blocks = sj.sample_with_key(g, jnp.asarray(seeds),
                                jax.random.fold_in(jax.random.key(1), 0))
    indptr = np.asarray(g.indptr)
    return got, blocks, sj.spec.caps, indptr[1:] - indptr[:-1], avg


def test_live_sizes_and_counts_match_the_reference_blocks(runs):
    got, blocks, caps, deg, _ = runs
    want = perf.gnn_layer_sizes(blocks, caps, deg)
    assert got["layer_sizes"][0] == want
    assert [s["T"] for s in want][-1] == got["sampled_v"][0]
    work, model = perf.gnn_work(want, [100, 256, 256, 47])
    assert got["work"] == {"bytes": work.bytes, "flops": work.flops,
                           "model_flops": model}
    assert got["flops_per_device"] == work.flops
    assert got["t_collective_s"] == 0.0 and got["world_size"] == 1


def test_geometry_is_the_reference_formula(runs):
    got, _, _, _, avg = runs
    # src/repro/launch/dryrun.py:195-204, restated
    sizes = [B]
    for k in (10, 10, 10):
        sizes.append(sizes[-1] * (1 + min(k, avg)))
    dims = [100, 256, 256, 47]
    mf = 0.0
    for layer in range(3):
        mf += 2 * sizes[3 - 1 - layer] * dims[layer] * dims[layer + 1] * 2
    mf *= 3
    assert got["model_flops_geometry"] == mf
    assert got["model_flops_geometry"] > got["work"]["model_flops"]


def test_cpu_runs_have_no_time_fields(runs):
    got = runs[0]
    for k in ("warm_step_seconds", "measured_s", "mfu", "step_seconds",
              "device_busy_ms", "device_idle_share", "peak_memory_gib",
              "card"):
        assert got[k] is None, k
    assert got["dominant"] in ("compute", "memory")
    assert len(got["step_records"][0]["frontiers"]) == 4


def test_main_fails_without_a_card(tmp_path):
    assert not torch.cuda.is_available()
    assert perf.main(["--cell", "gnn", "--variant", "labor0",
                      "--out", str(tmp_path)]) != 0
    assert not list(tmp_path.iterdir())
    with pytest.raises(RuntimeError, match="is_available"):
        perf.measure_gnn(device="cuda")


def test_measure_lm_counts_on_the_cpu():
    """gemma2-2b's reduced config (2 layers, width 64): the parameter
    count is the reference's (``jax.eval_shape``), the model FLOPs 6 N
    tokens, the counted FLOPs below the plain path's full-square count
    by the masked-out causal pairs; no time field."""
    from repro import configs as jconfigs
    from repro.configs.reduce import reduce_cfg as jreduce
    from repro.models.transformer import stack as jstack
    from repro_torch import configs
    from repro_torch.configs.reduce import reduce_cfg

    cfg = reduce_cfg(configs.get_config("gemma2-2b", dtype="float32"))
    jcfg = jreduce(jconfigs.get_config("gemma2-2b", dtype="float32"))
    n = float(sum(int(np.prod(x.shape)) for x in jax.tree.leaves(
        jax.eval_shape(lambda: jstack.init_params(jax.random.key(0),
                                                  jcfg)))))
    got = perf.measure_lm("gemma2-2b", "train_4k", cfg=cfg, batch=2,
                          seq_len=64, device="cpu")
    assert got["params"] == n
    assert got["model_flops_total"] == 6.0 * n * 2 * 64
    assert got["warm_step_seconds"] is None and got["mfu"] is None
    excess = perf._attention_excess(cfg, 2, 64)
    assert excess > 0 and got["work"]["flops"] > 0
    assert got["account"]["resident"] == (
        got["account"]["params"] + got["account"]["opt_state"])
    assert dryrun._param_count(cfg) == n
