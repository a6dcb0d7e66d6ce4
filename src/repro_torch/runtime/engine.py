"""The train and infer engine (twin of ``repro.runtime.engine.
TrainEngine``), on one device or on a mesh of ranks.

A train :meth:`TrainEngine.step` runs, eagerly, what the reference's
fused one-program step runs: sample the blocks (no gradient), gather
the deepest layer's features, the GCN forward, the masked mean NLL and
accuracy, the backward, global-norm clipping and Adam. The update of
the parameters and the optimizer state is gated on the device by the
batch's overflow flags (``torch.where``, no host read); the flags are
read one step late by the :class:`~repro_torch.data.gnn_loader.
OverflowLedger`, and an overflowed batch is replayed with doubled caps.
An infer request (:meth:`TrainEngine.infer`) samples, gathers and runs
the forward; :meth:`TrainEngine.infer_with_retry` doubles every cap and
re-runs the same key when a flag is set; :meth:`TrainEngine.
cached_infer_fn` is the same request with the feature gather routed
through a device-resident feature cache and, optionally, the deepest
layer's output through a hidden-state cache (``repro_torch.serving``).
With a :class:`~repro_torch.runtime.guard.GuardConfig` the step also
computes the guard's ``[nonfinite, spike]`` flags on the device and
gates the update on them too (``m["guard_flags"]``); with the guard off
the step is the unguarded one op for op. :meth:`TrainEngine.
sample_stage`, :meth:`TrainEngine.gather_stage` and the compute are the
step's stages, which the pipelined driver (``runtime/pipeline.py``)
runs ahead of each other: the serial step is made of the same pieces in
the same order.

On a mesh (``mesh=``, a ``launch.mesh.Mesh``: one process per rank,
where the reference runs one ``shard_map``) every rank runs the same
step on its destination-owned modulo partition (``graph/partition.
py``):

  1. **Seed routing.** Each layer's frontier is sent to the owner of
     each vertex (v % P) through a fixed-capacity all-to-all and
     deduplicated there (``hash_dedup``), so every vertex is sampled
     once, partition-locally, with GLOBAL ids: the hash r_t is a
     function of the global id, so the union of the ranks' sampled sets
     is the single-device set bit for bit. Batch-global state (LABOR's
     importance pi, LADIES's column norms) is completed with one
     pmax / psum.
  2. **Feature and hidden exchange.** The deepest layer's features come
     from their owners through ``distributed.feature_exchange``; between
     GNN layers the hidden states cross ranks through the same
     all-to-all (owners scatter their outputs into an owned-row buffer,
     consumers fetch by global id), and its backward sends the
     gradients back.
  3. **Gradient all-reduce.** The per-rank gradients are mean-reduced
     (optionally bf16 / int8-compressed with error feedback,
     ``distributed.compression``) and every rank applies the same Adam
     update.

Every static cap of the mesh step (the LayerCaps and the per-peer
all-to-all caps, ``SamplerSpec.peer_caps``) comes from the sampler, and
every overflow (sampling, seed routing, the feature or hidden exchange)
feeds one flag vector, max-reduced over the ranks, so one protocol
covers them all: the update is gated, the ledger reads the flags one
step late and the batch is replayed with ``Sampler.doubled`` caps.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.interface import (Sampler, overflow_flags,
                                        sampled_counts)
from repro_torch.data.gnn_loader import (LoaderStats, OverflowLedger,
                                         SamplingOverflowError)
from repro_torch.distributed import compression as comp
from repro_torch.distributed.feature_exchange import (exchange_features,
                                                      request_layout,
                                                      take_rows)
from repro_torch.graph.csr import Graph
from repro_torch.graph.partition import partition_part, partition_rows
from repro_torch.ops import frontier as frontier_ops
from repro_torch.ops.backend import resolve_backend
from repro_torch.optim import adam
from repro_torch.runtime.guard import (GuardConfig, RetryPolicy,
                                       guard_update, init_guard_state)


def gather_feats(features: torch.Tensor, block) -> torch.Tensor:
    """Rows of ``features`` for ``block.next_seeds`` (zeros at -1)."""
    return take_rows(features, block.next_seeds)


def seed_labels(labels: torch.Tensor, seeds: torch.Tensor) -> torch.Tensor:
    """The labels of a padded seed batch (label 0 at padding slots)."""
    return labels[torch.where(seeds >= 0, seeds, 0).long()]


def gnn_loss_fn(model, blocks, feats: torch.Tensor, labels: torch.Tensor,
                backend: Optional[str] = None):
    """Masked mean NLL and accuracy over the batch's real seeds;
    ``labels`` are the seeds' labels (any value at padding)."""
    logits = model(blocks, feats, backend=backend)
    valid = blocks[0].seeds >= 0
    safe = torch.where(valid, labels, 0).long()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, 1, safe[:, None])[:, 0]
    nll = torch.where(valid, lse - gold, 0.0)
    n = torch.clamp(valid.sum(), min=1)
    loss = nll.sum() / n
    acc = ((torch.argmax(logits, -1) == safe) & valid).sum() / n
    return loss, acc


@dataclasses.dataclass(frozen=True)
class EngineData:
    """Request-invariant inputs, on the engine's device. On a mesh,
    ``graph`` is this rank's partition (the in-edge CSR of its owned
    destinations, global source ids, ``ceil(V/P)`` rows) and
    ``features``/``labels`` its owned rows (vertex ``v`` at row
    ``v // P`` of rank ``v % P``)."""
    graph: Graph
    features: torch.Tensor
    labels: torch.Tensor


@dataclasses.dataclass(frozen=True)
class EngineState:
    """The optimizer state (``adam.init_state``: moments and step), the
    guardrail's loss EMA (``guard``: None unless the engine has a
    :class:`~repro_torch.runtime.guard.GuardConfig`) and the gradient
    compression's error feedback (``err``: None unless compressing).
    All three ride in checkpoints."""
    opt: Any
    guard: Any = None
    err: Any = None


@dataclasses.dataclass
class MeshBatch:
    """The sampled half of one mesh step on one rank: the blocks over
    this rank's owned seeds, each layer's owned local rows, the routing
    overflow flags, the owned frontier of every layer (and, in training,
    of the deepest one), the deepest frontier's owned count and the
    partition's row count."""
    blocks: tuple
    owned_rows: tuple
    route_flags: torch.Tensor
    frontiers: tuple
    deep_n: Optional[torch.Tensor]
    v_local: int


def _route_to_owners(ids: torch.Tensor, mesh, per_peer_cap: int,
                     owned_cap: int, v_local: int,
                     backend: Optional[str] = None):
    """Send each padded global id (-1 pad) to its owner (v % P) through a
    fixed-capacity all-to-all and deduplicate there.

    Returns (owned ids int32[owned_cap]: global ids in ascending local
    row, -1 pad; their local rows (0 at padding); the owned count; the
    overflow flag: a per-peer send cap or the owner's buffer
    exceeded)."""
    P = mesh.size
    req_rows, _, send_ovf = request_layout(ids, P, per_peer_cap, v_local,
                                           owner_mode="mod")
    incoming = mesh.all_to_all(req_rows).reshape(-1)
    # the owner's dedup through the epilogue's frontier primitive:
    # unique local rows, ascending (an order that replays keep)
    dd = frontier_ops.hash_dedup(incoming, incoming >= 0, None, owned_cap,
                                 backend=backend)
    rows = dd.new
    owned = torch.where(rows >= 0, rows * P + mesh.rank, -1).to(torch.int32)
    return (owned, torch.where(rows >= 0, rows, 0), dd.num_new,
            send_ovf | dd.overflow)


def _scatter_owned_rows(rows: torch.Tensor, valid: torch.Tensor,
                        values: torch.Tensor, v_local: int) -> torch.Tensor:
    """Per-seed rows into a dense (v_local, F) owned-row buffer, the
    response table of the next modulo all-to-all (differentiable): each
    row's seed (the owned rows are unique), then one gather, so no two
    writes land on one row; zeros where no valid seed owns the row."""
    S = values.shape[0]
    seeds = torch.arange(S, device=values.device)
    at = torch.full((v_local + S,), -1, dtype=torch.int64,
                    device=values.device)
    at = at.scatter_(0, torch.where(valid, rows.long(), v_local + seeds),
                     seeds)[:v_local]
    return take_rows(values, at)


def _owned_cap_schedule(spec, P: int):
    """The owners' seed buffer caps per layer and the deepest frontier's:
    bounded by what the all-to-all can deliver and kept under the
    layer's vertex buffer, so next_seeds keeps room for new vertices
    (both double together on an overflow replay)."""
    caps, peer, L = spec.caps, spec.peer_caps, spec.num_layers
    owned = [min(P * peer[l], max(caps[l].vertex_cap // 2, 8))
             for l in range(L)]
    return owned, min(P * peer[L], caps[-1].vertex_cap)


def _route_and_sample(sampler, mesh, graph_l: Graph, v_local: int, seeds,
                      salts, *, with_deep: bool,
                      backend: Optional[str] = None) -> MeshBatch:
    """The partitioned sampling half: per layer, route the frontier to
    its owners and sample there with global ids; ``with_deep`` (train:
    |V^L| is the paper's headline metric and the set the parity tests
    compare) also deduplicates the deepest frontier at its owners."""
    spec = sampler.spec
    L, peer, P = spec.num_layers, spec.peer_caps, mesh.size
    owned_caps, deep_cap = _owned_cap_schedule(spec, P)
    blocks, owned_rows, route_ovf, frontiers = [], [], [], []
    frontier = seeds
    for l in range(L):
        owned, rows, _, r_ovf = _route_to_owners(
            frontier, mesh, peer[l], owned_caps[l], v_local, backend)
        blk = sampler.sample_layer_partitioned(
            graph_l, owned, salts[l], l, seed_rows=rows,
            num_vertices=P * v_local, mesh=mesh, backend=backend)
        blocks.append(blk)
        owned_rows.append(rows)
        route_ovf.append(r_ovf)
        frontiers.append(owned)
        frontier = blk.next_seeds
    deep_n = None
    if with_deep:
        deep, _, deep_n, d_ovf = _route_to_owners(
            frontier, mesh, peer[L], deep_cap, v_local, backend)
        frontiers.append(deep)
        route_ovf.append(d_ovf)
    return MeshBatch(blocks=tuple(blocks), owned_rows=tuple(owned_rows),
                     route_flags=torch.stack(route_ovf),
                     frontiers=tuple(frontiers), deep_n=deep_n,
                     v_local=v_local)


def _forward_partitioned(model, blocks, owned_rows, h, peer, mesh,
                         v_local: int, backend: Optional[str] = None):
    """The partitioned forward: between GNN layers the hidden states
    cross ranks through the fixed-capacity all-to-all. Returns (logits
    over the owned layer-0 seeds, the hidden exchanges' overflow
    flags)."""
    L = len(blocks)
    h_ovfs = []
    for b in range(L - 1, -1, -1):
        h = model.layers[L - 1 - b](blocks[b], h, is_last=b == 0,
                                    backend=backend)
        if b > 0:
            dense = _scatter_owned_rows(owned_rows[b], blocks[b].seeds >= 0,
                                        h, v_local)
            h, ovf = exchange_features(dense, blocks[b - 1].next_seeds,
                                       mesh, peer[b], owner_mode="mod")
            h_ovfs.append(ovf)
    return h, h_ovfs


class TrainEngine:
    """``TrainEngine(sampler, opt_cfg, mesh=None, device=...,
    backend=...)``.

    ``step``/``flush``/``infer`` take the model (a
    ``repro_torch.models.gnn.GCN``) where the reference takes its params
    pytree; ``step`` updates the model's parameters in place and returns
    it::

        eng = TrainEngine(sampler, adam.AdamConfig(lr=1e-3))
        data = eng.make_data_from_dataset(ds)
        state = eng.init_state(model)
        for seeds, key in batches:
            model, state, m = eng.step(model, state, data, seeds, key)
        model, state, _ = eng.flush(model, state, data)  # drain the ledger

    On a mesh every rank builds the engine with its ``Mesh`` and calls
    the same methods with the same GLOBAL seed batch and key (each rank
    takes its contiguous share of the batch); the engine runs on
    ``mesh.device``. The sampler needs ``spec.peer_caps``
    (``samplers.from_dataset(..., num_parts=P)`` at the rank-local batch
    size) and the model per-layer modules (``model.layers``). A train
    step's metrics add ``frontiers``: each layer's frontier (and the
    deepest one), the ranks' owned shares concatenated (-1 pad), so the
    union of its ids is the single-device set; and ``feat_rows``, the
    live rows the feature all-to-all fetched, over all ranks.
    """

    def __init__(self, sampler: Sampler, opt_cfg: Optional[adam.AdamConfig]
                 = None, mesh=None, *, device="cuda",
                 backend: Optional[str] = None,
                 stats: Optional[LoaderStats] = None,
                 guard: Optional[GuardConfig] = None, inject: Any = None,
                 grad_compression: str = "none",
                 max_replay_retries: int = 3):
        self.mesh = mesh
        if mesh is not None:
            device = mesh.device
            if sampler.spec.peer_caps is None:
                raise ValueError(
                    f"sampler {sampler.name!r} has no per-peer all-to-all "
                    "caps; build it with samplers.from_dataset(..., "
                    f"num_parts={mesh.size}) for the mesh engine")
        elif grad_compression != "none":
            raise ValueError("gradient compression compresses the mesh's "
                             "all-reduce: it needs a mesh")
        #: the number of ranks (1 off a mesh)
        self.num_parts = 1 if mesh is None else mesh.size
        self.comp_cfg = comp.CompressionConfig(grad_compression)
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' was asked for but CUDA is not "
                               "available (pass device='cpu' to run the "
                               "plain versions on the CPU)")
        self.sampler = sampler
        self.opt_cfg = opt_cfg or adam.AdamConfig()
        self.backend = resolve_backend(backend, self.device)
        self.stats = stats or LoaderStats()
        #: the guardrail's configuration (None: off)
        self.guard = guard
        #: the fault-injection plan (``runtime/inject.py``); the engine
        #: owns the ``overflow_storm`` site (:meth:`_read_overflow`)
        self.inject = inject
        self.max_replay_retries = max_replay_retries
        #: dispatched train steps (a clean guarded run dispatches as many
        #: as an unguarded one)
        self.dispatches = 0
        self._ovf_reads = 0
        #: (tag, metrics) of every replay attempt, for step-indexed
        #: histories
        self.replayed: List[Tuple[Any, Dict[str, Any]]] = []
        self._ledger = OverflowLedger(self.stats)
        # bumped by grow(): the first request at new caps is tagged as a
        # set-up event by the serving metrics
        self.generation = 0
        #: cache-aware infer functions by (feature cache, hidden cache)
        self._infer_cached: Dict[Any, Any] = {}

    def init_state(self, model) -> EngineState:
        params = {k: p.detach() for k, p in model.named_parameters()}
        return EngineState(
            opt=adam.init_state(params, self.opt_cfg),
            guard=(None if self.guard is None
                   else init_guard_state(self.device)),
            err=comp.init_error_state(params, self.comp_cfg))

    def make_data(self, graph: Graph, features, labels) -> EngineData:
        """The request-invariant inputs on the engine's device: whole on
        one device, this rank's partition on a mesh (module
        docstring)."""
        if self.mesh is None:
            return EngineData(
                graph=graph.to(self.device),
                features=torch.as_tensor(features, dtype=torch.float32).to(
                    self.device),
                labels=torch.as_tensor(labels).to(self.device))
        if graph.weights is not None:
            raise NotImplementedError(
                "the partitioned engine does not thread edge weights yet")
        P, r = self.mesh.size, self.mesh.rank
        indptr, indices = partition_part(graph, P, r)
        feats = np.asarray(features.cpu() if torch.is_tensor(features)
                           else features, dtype=np.float32)
        labs = np.asarray(labels.cpu() if torch.is_tensor(labels)
                          else labels)
        dev = self.device
        return EngineData(
            graph=Graph(indptr=torch.as_tensor(indptr, device=dev),
                        indices=torch.as_tensor(indices, device=dev)),
            features=torch.as_tensor(partition_rows(feats, P, r),
                                     device=dev),
            labels=torch.as_tensor(partition_rows(labs, P, r), device=dev))

    def make_data_from_dataset(self, ds) -> EngineData:
        return self.make_data(ds.graph, ds.features, ds.labels)

    def grow(self):
        """Double every static cap (the logarithmic retry schedule); the
        cache-aware infer functions are built anew for the new caps."""
        self.sampler = self.sampler.doubled()
        self.generation += 1
        self._infer_cached.clear()

    # ------------------------------------------------------------------
    # the train step, in the pieces it runs
    # ------------------------------------------------------------------

    def _local_seeds(self, seeds: torch.Tensor) -> torch.Tensor:
        """This rank's contiguous share of a global seed batch."""
        B, P = seeds.shape[0], self.num_parts
        if B % P:
            raise ValueError(f"global seed batch {B} must divide over {P} "
                             "ranks (pad with pad_seeds)")
        r = self.mesh.rank
        return seeds[r * (B // P):(r + 1) * (B // P)]

    @torch.no_grad()
    def sample_stage(self, graph: Graph, seeds: torch.Tensor, key, *,
                     with_deep: bool = True):
        """Sample the blocks at the current caps (no gradient); on a
        mesh, route and sample this rank's share (a :class:`MeshBatch`;
        ``with_deep`` also routes the deepest frontier)."""
        salts = self.sampler.spec.salts(key)
        if self.mesh is None:
            return tuple(self.sampler.sample(graph, seeds, salts,
                                             backend=self.backend))
        return _route_and_sample(self.sampler, self.mesh, graph,
                                 graph.num_vertices, self._local_seeds(seeds),
                                 salts, with_deep=with_deep,
                                 backend=self.backend)

    @torch.no_grad()
    def gather_stage(self, features, labels_all, blocks):
        """The deepest layer's features and the seeds' labels:
        (feats, labels); on a mesh (``blocks`` a :class:`MeshBatch`) the
        features come through the feature all-to-all: (feats, labels,
        its overflow flag)."""
        if self.mesh is None:
            return (gather_feats(features, blocks[-1]),
                    seed_labels(labels_all, blocks[0].seeds))
        b = blocks
        feats, f_ovf = exchange_features(
            features, b.blocks[-1].next_seeds, self.mesh,
            self.sampler.spec.peer_caps[-1], owner_mode="mod")
        valid0 = b.blocks[0].seeds >= 0
        labels = labels_all[torch.where(valid0, b.owned_rows[0], 0).long()]
        return feats, labels, f_ovf

    @torch.no_grad()
    def sample_batch(self, data: EngineData, seeds: torch.Tensor, key):
        """Sample the blocks and gather the deepest layer's features (no
        gradient): (blocks, feats)."""
        blocks = self.sample_stage(data.graph, seeds, key)
        return blocks, gather_feats(data.features, blocks[-1])

    @torch.no_grad()
    def apply_update(self, model, state: EngineState, grads, blocks,
                     loss: Optional[torch.Tensor] = None):
        """Clip + Adam, written into ``model`` and the new state unless
        the batch overflowed or, with the guard on, was flagged (gated on
        the device; ``loss`` feeds the guard). Returns (state,
        metrics)."""
        params = dict(model.named_parameters())
        state, m = self._gated_update(params, state,
                                      dict(zip(params, grads)),
                                      overflow_flags(blocks), loss)
        m.update(**sampled_counts(blocks))
        return state, m

    def _gated_update(self, params, state: EngineState, grads, ovf, loss,
                      err=None):
        """Adam into ``params`` and the new state unless ``ovf`` holds a
        flag or the guard flags the batch; ``err`` is the new error
        feedback, gated alike. Returns (state, metrics)."""
        new_p, new_opt, m = adam.apply_updates(
            {k: p.detach() for k, p in params.items()}, grads, state.opt,
            self.opt_cfg)
        bad = ovf.any()
        gstate = state.guard
        if self.guard is not None:
            # the twin of the reference's _guard_gate: the EMA never
            # absorbs a flagged or overflowed batch
            gflags, gstate = guard_update(self.guard, loss, grads,
                                          state.guard, bad)
            bad = bad | gflags.any()
            m["guard_flags"] = gflags
        for k, p in params.items():
            p.copy_(torch.where(bad, p, new_p[k]))

        def gate(new, old):
            if isinstance(new, dict):
                return {k: gate(new[k], old[k]) for k in new}
            return torch.where(bad, old, new)

        m.update(overflow=ovf)
        return EngineState(opt=gate(new_opt, state.opt), guard=gstate,
                           err=None if err is None else gate(err, state.err)
                           ), m

    def _compute(self, model, state: EngineState, blocks, feats, labels,
                 f_ovf=None):
        """Forward, loss, backward and the gated update of one sampled
        batch (on a mesh: a :class:`MeshBatch` and the feature exchange's
        overflow flag ``f_ovf``)."""
        if self.mesh is not None:
            return self._compute_mesh(model, state, blocks, feats, labels,
                                      f_ovf)
        loss, acc = gnn_loss_fn(model, blocks, feats, labels, self.backend)
        grads = torch.autograd.grad(loss, list(model.parameters()))
        loss = loss.detach()
        state, m = self.apply_update(model, state, grads, blocks, loss)
        m.update(loss=loss, acc=acc)
        return model, state, m

    def _compute_mesh(self, model, state: EngineState, batch: MeshBatch,
                      feats, labels, f_ovf):
        """One rank's forward (hidden states exchanged between layers),
        the batch-global mean NLL, the backward, the gradients' mean over
        the ranks and the gated Adam update, the same on every rank."""
        mesh, P = self.mesh, self.num_parts
        blocks = batch.blocks
        peer = self.sampler.spec.peer_caps
        valid0 = blocks[0].seeds >= 0
        total_valid = mesh.psum(valid0.sum(dtype=torch.int32))
        n = torch.clamp(total_valid, min=1)
        params = dict(model.named_parameters())
        logits, h_ovfs = _forward_partitioned(
            model, blocks, batch.owned_rows, feats, peer, mesh,
            batch.v_local, self.backend)
        safe = torch.where(valid0, labels, 0).long()
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, 1, safe[:, None])[:, 0]
        nll = torch.where(valid0, lse - gold, 0.0)
        # x P, so that the mean of the ranks' gradients is the gradient
        # of the batch-global mean NLL
        local = nll.sum() * P / n
        correct = ((torch.argmax(logits, -1) == safe) & valid0).sum()
        grads = torch.autograd.grad(local, list(params.values()))
        with torch.no_grad():
            grads, new_err = comp.compressed_mean(
                dict(zip(params, grads)), state.err, self.comp_cfg, mesh)
            flags = torch.cat([overflow_flags(blocks), batch.route_flags,
                               torch.stack([f_ovf] + h_ovfs)])
            ovf = mesh.pmax(flags.to(torch.int32)) > 0
            # the metrics' sums in one all-reduce (float64: the counts
            # stay exact)
            sums = mesh.psum(torch.stack([
                local.detach().double(), correct.double(),
                batch.deep_n.double(),
                sum(b.num_edges for b in blocks).double(),
                blocks[-1].num_next.double()]))
            loss = (sums[0] / P).float()
            state, m = self._gated_update(params, state, grads, ovf, loss,
                                          new_err)
            fronts = mesh.all_gather(torch.cat(batch.frontiers))
            sizes = [f.shape[0] for f in batch.frontiers]
            m.update(loss=loss, acc=(sums[1] / n).float(),
                     sampled_v=sums[2].to(torch.int32),
                     sampled_e=sums[3].to(torch.int32),
                     feat_rows=sums[4].to(torch.int64),
                     frontiers=tuple(c.reshape(-1) for c in
                                     fronts.split(sizes, dim=1)))
        return model, state, m

    def _dispatch(self, model, state: EngineState, data: EngineData, seeds,
                  key):
        self.dispatches += 1
        if self.mesh is not None:
            batch = self.sample_stage(data.graph, seeds, key)
            return self._compute(model, state, batch,
                                 *self.gather_stage(data.features,
                                                    data.labels, batch))
        blocks, feats = self.sample_batch(data, seeds, key)
        return self._compute(model, state, blocks, feats,
                             seed_labels(data.labels, seeds))

    def _read_overflow(self, m) -> torch.Tensor:
        """The one place a step's overflow flags are taken for the
        ledger and the replay, and so the ``overflow_storm`` site: a
        firing storm replaces the flags with all-true, which drives the
        grow-and-replay path as a real persistent overflow would."""
        flags = m["overflow"]
        if self.inject is not None and self.inject.armed("overflow_storm"):
            if self.inject.fires("overflow_storm",
                                 self._ovf_reads) is not None:
                flags = torch.ones_like(flags)
        self._ovf_reads += 1
        return flags

    def reset_protocol(self):
        """Drop the overflow window unread (the guardrail's rollback: its
        entries belong to a discarded trajectory)."""
        self._ledger = OverflowLedger(self.stats, depth=self._ledger.depth)

    def step(self, model, state: EngineState, data: EngineData, seeds, key,
             tag: Any = None):
        """One train step under the async overflow protocol: the update
        is gated on the device; the PREVIOUS batch's flags are read (it
        has finished) and an overflowed batch is replayed with doubled
        caps. Returns (model, state, metrics) of THIS batch; replay
        metrics land in :attr:`replayed`."""
        model, state, m = self._dispatch(model, state, data, seeds, key)
        due = self._ledger.record((seeds, key, tag, self.sampler),
                                  self._read_overflow(m))
        if due is not None:
            model, state, _ = self._replay(model, state, data, *due)
        return model, state, m

    def flush(self, model, state: EngineState, data: EngineData):
        """Resolve the last batch (end of training, or before a
        checkpoint is saved). Returns (model, state, metrics of the
        replayed batch or None)."""
        due = self._ledger.flush()
        if due is None:
            return model, state, None
        return self._replay(model, state, data, *due)

    def _replay(self, model, state, data, seeds, key, tag, sampler_then):
        box = {"state": state, "then": sampler_then}

        def attempt(_i):
            if self.sampler is box["then"]:
                self.stats.overflow_retries += 1
                self.grow()
            _, s, m = self._dispatch(model, box["state"], data, seeds, key)
            box["state"] = s
            self.replayed.append((tag, m))
            if bool(self._read_overflow(m).any()):
                box["then"] = self.sampler
                return None
            return model, s, m

        return RetryPolicy(self.max_replay_retries).run(
            attempt, error=SamplingOverflowError,
            describe="sampling overflow persisted after cap doubling")

    # ------------------------------------------------------------------
    # inference
    # ------------------------------------------------------------------

    @torch.no_grad()
    def infer_blocks(self, params, data: EngineData, seeds: torch.Tensor,
                     key):
        """Sample + gather + forward for one padded seed batch; returns
        (logits, overflow flags bool[num_layers], blocks)."""
        blocks, feats = self.sample_batch(data, seeds, key)
        logits = params(blocks, feats, backend=self.backend)
        return logits, overflow_flags(blocks), blocks

    @torch.no_grad()
    def _infer_mesh(self, model, data: EngineData, seeds: torch.Tensor, key):
        """The mesh's infer request: route and sample this rank's share,
        the feature exchange, the partitioned forward. Returns (owned
        seeds, logits, flags), the ranks' owned rows concatenated: row i
        of ``logits`` answers global vertex ``owned[i]`` (-1 pad); the
        flags are max-reduced over the ranks."""
        mesh = self.mesh
        batch = self.sample_stage(data.graph, seeds, key, with_deep=False)
        feats, _, f_ovf = self.gather_stage(data.features, data.labels,
                                            batch)
        logits, h_ovfs = _forward_partitioned(
            model, batch.blocks, batch.owned_rows, feats,
            self.sampler.spec.peer_caps, mesh, batch.v_local, self.backend)
        flags = torch.cat([overflow_flags(batch.blocks), batch.route_flags,
                           torch.stack([f_ovf] + h_ovfs)])
        flags = mesh.pmax(flags.to(torch.int32)) > 0
        owned = batch.blocks[0].seeds
        return (mesh.all_gather(owned).reshape(-1),
                mesh.all_gather(logits).reshape(-1, logits.shape[-1]), flags)

    def infer(self, params, data: EngineData, seeds: torch.Tensor, key):
        """(logits, overflow flags) for one padded seed batch; on a mesh
        (owned seeds, logits, flags), as :meth:`_infer_mesh`."""
        if self.mesh is not None:
            return self._infer_mesh(params, data, seeds, key)
        logits, flags, _ = self.infer_blocks(params, data, seeds, key)
        return logits, flags

    def infer_with_retry(self, params, data: EngineData, seeds, key, *,
                         max_retries: int = 4):
        """:meth:`infer` under the overflow-retry contract: on overflow,
        :meth:`grow` and re-run the SAME key (the sampled set is
        salt-determined, so the retry answers the same request, just
        untruncated). Raises ``SamplingOverflowError`` when
        ``max_retries`` doublings do not clear it. Returns
        ``(logits, grows)``."""
        grows = {"n": 0}

        def attempt(_i):
            out = self.infer(params, data, seeds, key)
            if bool(out[-1].any()):       # one host read per request
                return None
            return out

        def escalate(_i):
            self.grow()
            self.stats.overflow_retries += 1
            grows["n"] += 1

        out = RetryPolicy(max_retries).run(
            attempt, grow=escalate, error=SamplingOverflowError,
            describe="sampling overflow persisted after cap doubling "
                     "while serving")
        return (out[0] if self.mesh is None else out), grows["n"]

    def cached_infer_fn(self, feature_cache=None, hidden_cache=None):
        """The cache-aware infer request: :meth:`infer` with the feature
        gather routed through a device-resident
        :class:`~repro_torch.serving.cache.VertexCache` (only the unique
        misses are read from ``features``) and, optionally, the deepest
        layer's output substituted from a
        :class:`~repro_torch.serving.cache.HiddenCache` under its
        staleness bound. Signature, as the reference's::

            infer_c(model, graph, features, fc_state, hc_state, seeds,
                    key) -> (logits, overflow_flags, fc_state',
                             hc_state', cache_metrics)

        ``None`` stands for a disabled cache's state. Feature-cache rows
        are verbatim feature rows, so the logits equal :meth:`infer`'s
        bit for bit; so do they with the hidden cache at ``max_age=0``.
        The hidden cache runs the model's layers one by one
        (``model.layers``) and raises ``ValueError`` for a model without
        them. One function per cache pair is kept, and :meth:`grow`
        drops them."""
        if self.mesh is not None:
            raise NotImplementedError(
                "cached inference is single-device; the mesh's infer path "
                "reads owner-partitioned features already")
        cache_key = (feature_cache, hidden_cache)
        fn = self._infer_cached.get(cache_key)
        if fn is not None:
            return fn
        sampler, backend = self.sampler, self.backend

        @torch.no_grad()
        def infer_c(model, graph, features, fc_state, hc_state, seeds,
                    key):
            if hidden_cache is not None and not hasattr(model, "layers"):
                raise ValueError(
                    "the hidden-state cache needs a per-layer model (one "
                    "with .layers, as repro_torch.models.gnn's); got "
                    f"{type(model).__name__!r}")
            blocks = sampler.sample(graph, seeds, sampler.spec.salts(key),
                                    backend=backend)
            metrics = {}
            if feature_cache is not None:
                feats, fc_state_out, fm = feature_cache.gather(
                    fc_state, blocks[-1].next_seeds,
                    lambda missed: take_rows(features, missed),
                    backend=backend)
                metrics.update(fm)
            else:
                feats, fc_state_out = gather_feats(features, blocks[-1]), None
            if hidden_cache is None:
                logits, hc_state_out = model(blocks, feats,
                                             backend=backend), None
            else:
                L = len(blocks)
                h = feats
                for l, blk in enumerate(reversed(blocks)):
                    h = model.layers[l](blk, h, is_last=l == L - 1,
                                        backend=backend)
                    if l == 0 and L > 1:
                        # the deepest layer's output, keyed by its seeds
                        h, hc_state, hm = hidden_cache.substitute(
                            hc_state, blk.seeds, h, backend=backend)
                        metrics.update(hm)
                logits, hc_state_out = h, hc_state
            return (logits, overflow_flags(blocks), fc_state_out,
                    hc_state_out, metrics)

        self._infer_cached[cache_key] = infer_c
        return infer_c
