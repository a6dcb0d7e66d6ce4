"""The single-device train and infer engine (twin of the single-device
half of ``repro.runtime.engine.TrainEngine``).

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
the same order. Gradient compression and the multi-device engine are
not ported: asking for them raises.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.core.interface import (Sampler, overflow_flags,
                                        sampled_counts)
from repro_torch.data.gnn_loader import (LoaderStats, OverflowLedger,
                                         SamplingOverflowError)
from repro_torch.graph.csr import Graph
from repro_torch.ops.backend import resolve_backend
from repro_torch.optim import adam
from repro_torch.runtime.guard import (GuardConfig, RetryPolicy,
                                       guard_update, init_guard_state)


def take_rows(features: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Rows of ``features`` at ``ids``; padding ids (-1) read no row and
    give zeros (the reference's ``mode="fill"``: a negative torch index
    would silently read the last row)."""
    valid = ids >= 0
    rows = features[torch.where(valid, ids, 0).long()]
    return torch.where(valid[:, None], rows, 0.0)


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
    """Request-invariant inputs, on the engine's device."""
    graph: Graph
    features: torch.Tensor
    labels: torch.Tensor


@dataclasses.dataclass(frozen=True)
class EngineState:
    """The optimizer state (``adam.init_state``: moments and step) and
    the guardrail's loss EMA (``guard``: None unless the engine has a
    :class:`~repro_torch.runtime.guard.GuardConfig`). Both ride in
    checkpoints."""
    opt: Any
    guard: Any = None


class TrainEngine:
    """``TrainEngine(sampler, opt_cfg, device=..., backend=...)``.

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
    """

    def __init__(self, sampler: Sampler, opt_cfg: Optional[adam.AdamConfig]
                 = None, mesh=None, *, device="cuda",
                 backend: Optional[str] = None,
                 stats: Optional[LoaderStats] = None,
                 guard: Optional[GuardConfig] = None, inject: Any = None,
                 grad_compression: str = "none",
                 max_replay_retries: int = 3):
        if mesh is not None or grad_compression != "none":
            raise NotImplementedError(
                "the mesh engine and gradient compression are not ported "
                "to repro_torch yet")
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
        return EngineState(
            opt=adam.init_state(
                {k: p.detach() for k, p in model.named_parameters()},
                self.opt_cfg),
            guard=(None if self.guard is None
                   else init_guard_state(self.device)))

    def make_data(self, graph: Graph, features, labels) -> EngineData:
        return EngineData(
            graph=graph.to(self.device),
            features=torch.as_tensor(features, dtype=torch.float32).to(
                self.device),
            labels=torch.as_tensor(labels).to(self.device))

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

    @torch.no_grad()
    def sample_stage(self, graph: Graph, seeds: torch.Tensor, key):
        """Sample the blocks at the current caps (no gradient)."""
        return tuple(self.sampler.sample(graph, seeds,
                                         self.sampler.spec.salts(key),
                                         backend=self.backend))

    @torch.no_grad()
    def gather_stage(self, features, labels_all, blocks):
        """The deepest layer's features and the seeds' labels:
        (feats, labels)."""
        return (gather_feats(features, blocks[-1]),
                seed_labels(labels_all, blocks[0].seeds))

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
        grads = dict(zip(params, grads))
        new_p, new_opt, m = adam.apply_updates(
            {k: p.detach() for k, p in params.items()}, grads, state.opt,
            self.opt_cfg)
        ovf = overflow_flags(blocks)
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

        m.update(overflow=ovf, **sampled_counts(blocks))
        return EngineState(opt=gate(new_opt, state.opt), guard=gstate), m

    def _compute(self, model, state: EngineState, blocks, feats, labels):
        """Forward, loss, backward and the gated update of one sampled
        batch."""
        loss, acc = gnn_loss_fn(model, blocks, feats, labels, self.backend)
        grads = torch.autograd.grad(loss, list(model.parameters()))
        loss = loss.detach()
        state, m = self.apply_update(model, state, grads, blocks, loss)
        m.update(loss=loss, acc=acc)
        return model, state, m

    def _dispatch(self, model, state: EngineState, data: EngineData, seeds,
                  key):
        self.dispatches += 1
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

    def infer(self, params, data: EngineData, seeds: torch.Tensor, key):
        """(logits, overflow flags) for one padded seed batch."""
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
        return out[0], grows["n"]

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
