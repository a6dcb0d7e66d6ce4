"""The GNN training loop (twin of ``repro.runtime.trainer``'s
``GNNTrainConfig``, ``build_sampler``, ``make_gnn_train_step``,
``train_gnn`` and ``evaluate_gnn``), on one device or on a mesh.

The batch schedule is a pure function of the step: seeds
``SeedBatches.at(step)``, key ``fold_in(key(seed + 1), step)``, as in
the reference; the parameters start from the model's init (``MODELS``:
``gcn``, ``sage`` or ``gatv2``) at ``key(seed)``. A step goes through
:meth:`TrainEngine.step` (the reference's fused path, one-step-late
overflow replay), through the pipelined driver (``pipeline="prefetch"``
or ``"full"``, ``runtime/pipeline.py``), or, with ``fused=False``,
through the unfused step (:func:`make_gnn_train_step`) after an eager
sampling retry. With ``ckpt_dir`` the run resumes from the newest
verified checkpoint and saves every ``ckpt_every`` steps and at the end;
with ``guard`` it runs the guardrail (``runtime/guard.py``): a flagged
batch is quarantined (re-drawn under fresh salts) or rolled back to the
last verified checkpoint, and the loop resumes bit for bit. ``inject``
arms the fault-injection plan (``runtime/inject.py``), and a
``runtime.fault_tolerance.Preemptor`` passed to :func:`train_gnn` plays
the preemption signal, checked before each step.

With ``mesh_devices`` = N the loop runs on every rank of an N-rank
process group (``launch.mesh.spawn``, or the train launcher's
``--mesh-devices``; one rank sets up its own group): the engine is the
mesh engine, its sampler sized for the rank-local batch with the
per-peer all-to-all caps, and ``grad_compression`` compresses the
gradient all-reduce. Every rank takes the same global batches and keys
and ends with the same parameters; rank 0 alone writes checkpoints.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.core import rng as rng_lib
from repro_torch.core import samplers as sampler_registry
from repro_torch.core.interface import Sampler, pad_seeds
from repro_torch.data.gnn_loader import (LoaderStats, SeedBatches,
                                         sample_with_retry)
from repro_torch.distributed import compression
from repro_torch.graph.generators import GraphDataset
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import gnn as gnn_models
from repro_torch.optim import adam
from repro_torch.runtime import checkpoint as ckpt_lib
from repro_torch.runtime import inject as inject_lib
from repro_torch.runtime.engine import (TrainEngine, gather_feats,
                                        gnn_loss_fn, seed_labels)
from repro_torch.runtime.guard import (GuardConfig, GuardFault, GuardRail,
                                       init_guard_state, quarantine_key)
from repro_torch.runtime.pipeline import PipelinedEngine


@dataclasses.dataclass
class GNNTrainConfig:
    model: str = "gcn"                  # gcn | sage | gatv2
    hidden: int = 256
    fanouts: tuple = (10, 10, 10)
    sampler: str = "labor-0"            # a repro_torch.core.samplers entry
    layer_sizes: Optional[tuple] = None  # (p)ladies budgets; None -> default
    batch_size: int = 1000
    lr: float = 1e-3
    steps: int = 200
    seed: int = 0
    cap_safety: float = 2.0
    device: str = "cuda"
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 100
    # True: the engine's step (sampling, gather, forward, backward and
    # the gated Adam, one-step-late overflow replay); False: the unfused
    # step after an eager sampling retry
    fused: bool = True
    # "off": the engine's step; "prefetch" / "full": the pipelined
    # driver (requires fused)
    pipeline: str = "off"
    max_replay_retries: int = 3
    # the guardrail: "off", "quarantine" or "rollback" (requires fused)
    guard: str = "off"
    guard_spike_factor: float = 4.0
    guard_warmup: int = 5
    guard_max_quarantine: int = 2
    guard_max_rollbacks: int = 3
    # a runtime.inject spec string or a parsed FaultPlan
    inject: Any = None
    # > 0: the mesh engine over this many ranks (the process group of
    # launch.mesh); the batch is global and divides over the ranks
    mesh_devices: int = 0
    grad_compression: str = "none"      # none | bf16 | int8 (mesh only)

    def __post_init__(self):
        if self.grad_compression not in compression.MODES:
            raise ValueError(f"unknown grad_compression "
                             f"{self.grad_compression!r}; choose from "
                             f"{compression.MODES}")
        if self.model not in gnn_models.MODELS:
            raise ValueError(f"unknown model {self.model!r}; choose from "
                             f"{sorted(gnn_models.MODELS)}")


def build_sampler(ds: GraphDataset, cfg: GNNTrainConfig,
                  num_parts: Optional[int] = None) -> Sampler:
    """The registry entry with caps from the dataset's graph statistics
    (train and eval share it). On a mesh (``num_parts``) the caps are
    sized for the rank-local batch and the per-peer all-to-all schedule
    rides along."""
    batch = cfg.batch_size // num_parts if num_parts else cfg.batch_size
    return sampler_registry.from_dataset(
        cfg.sampler, ds, batch_size=batch, fanouts=cfg.fanouts,
        layer_sizes=cfg.layer_sizes, safety=cfg.cap_safety,
        num_parts=num_parts)


def make_gnn_train_step(opt_cfg: adam.AdamConfig, backend=None):
    """The unfused step, sampling done outside:
    ``step(model, opt_state, blocks, feats, labels) -> (model, opt_state,
    metrics)``; the update is applied, not gated."""

    def step(model, opt_state, blocks, feats, labels):
        loss, acc = gnn_loss_fn(model, blocks, feats, labels, backend)
        grads = torch.autograd.grad(loss, list(model.parameters()))
        params = dict(model.named_parameters())
        with torch.no_grad():
            new_p, opt_state, m = adam.apply_updates(
                {k: p.detach() for k, p in params.items()},
                dict(zip(params, grads)), opt_state, opt_cfg)
            for k, p in params.items():
                p.copy_(new_p[k])
        m.update(loss=loss.detach(), acc=acc)
        return model, opt_state, m

    return step


def train_gnn(ds: GraphDataset, cfg: GNNTrainConfig,
              preemptor=None) -> Dict[str, Any]:
    """Train for ``cfg.steps`` steps, resuming from ``cfg.ckpt_dir``.
    Returns {"params": the model, "history": per-step loss / acc /
    sampled_v / sampled_e, "stats": LoaderStats, "wall_time": seconds,
    "sampler": the final sampler}, plus "guard_stats" with the guard on
    and "inject_log" with a fault plan. ``preemptor.check(step)`` runs
    before each step; an exception that ends the run first lets the
    checkpoint save in flight land."""
    if len(ds.train_idx) < cfg.batch_size:
        raise ValueError(
            f"batch_size {cfg.batch_size} exceeds the {len(ds.train_idx)}"
            "-vertex train split (SeedBatches drops partial batches)")
    plan = cfg.inject
    if isinstance(plan, str):
        plan = inject_lib.parse(plan)
    mesh = None
    if cfg.mesh_devices:
        if not cfg.fused:
            raise ValueError("the mesh engine is always fused")
        mesh = make_mesh(cfg.mesh_devices, cfg.device)
    elif cfg.grad_compression != "none":
        raise ValueError("grad_compression compresses the mesh's "
                         "all-reduce: it needs mesh_devices")
    # rank 0 alone writes checkpoints; every rank reads them
    rank0 = mesh is None or mesh.rank == 0
    guard_cfg = None
    if cfg.guard != "off":
        if not cfg.fused:
            raise ValueError("the guardrail requires the fused engine "
                             "(fused=True): its flags ride in the engine "
                             "step's metrics")
        guard_cfg = GuardConfig(mode=cfg.guard,
                                spike_factor=cfg.guard_spike_factor,
                                warmup=cfg.guard_warmup,
                                max_quarantine=cfg.guard_max_quarantine,
                                max_rollbacks=cfg.guard_max_rollbacks)
    stats = LoaderStats()
    engine = TrainEngine(build_sampler(ds, cfg,
                                       num_parts=cfg.mesh_devices or None),
                         adam.AdamConfig(lr=cfg.lr), mesh=mesh,
                         device=cfg.device, stats=stats, guard=guard_cfg,
                         inject=plan,
                         grad_compression=cfg.grad_compression,
                         max_replay_retries=cfg.max_replay_retries)
    in_dim, n_cls = ds.features.shape[1], int(ds.labels.max()) + 1
    init = gnn_models.MODELS[cfg.model][0]
    model = init(rng_lib.key(cfg.seed), in_dim, cfg.hidden, n_cls,
                 len(cfg.fanouts), device=engine.device)
    data = engine.make_data_from_dataset(ds)
    state = engine.init_state(model)
    driver = None
    if cfg.pipeline != "off":
        if not cfg.fused:
            raise ValueError("pipeline modes require the fused engine "
                             "(fused=True)")
        driver = PipelinedEngine(engine, mode=cfg.pipeline)
    step_fn = (None if cfg.fused
               else make_gnn_train_step(engine.opt_cfg, engine.backend))

    def restore_tree(step):
        """The checkpoint of ``step`` as a state tree; a checkpoint
        without a guard entry restores everything else."""
        like = ckpt_lib.state_tree(model, state)
        try:
            return ckpt_lib.restore(cfg.ckpt_dir, step, like)
        except KeyError:
            if "guard" not in like:
                raise
            del like["guard"]
            return ckpt_lib.restore(cfg.ckpt_dir, step, like)

    start_step = 0
    saver = None
    if cfg.ckpt_dir:
        if rank0:
            saver = ckpt_lib.AsyncSaver(cfg.ckpt_dir, inject=plan)
        last = ckpt_lib.latest_step(cfg.ckpt_dir)
        if last is not None:
            meta = ckpt_lib.read_meta(cfg.ckpt_dir, last)
            engine.sampler = ckpt_lib.validate_restore_meta(
                meta, engine.sampler, mesh_devices=cfg.mesh_devices,
                grad_compression=cfg.grad_compression,
                backend=engine.backend)
            # a checkpoint without a guard entry keeps the fresh guard
            # state (its warmup runs again)
            state = ckpt_lib.load_state_tree(model, state,
                                             restore_tree(last))
            start_step = last

    batches = SeedBatches(ds.train_idx, cfg.batch_size, seed=cfg.seed,
                          device=engine.device)
    base_key = rng_lib.key(cfg.seed + 1)
    # metrics stay on the device during the loop; read once at the end
    device_history: List[Dict[str, Any]] = []
    rail = GuardRail(guard_cfg) if guard_cfg is not None else None
    # the rollback target while no verified checkpoint exists: a copy of
    # the starting state (the engine updates the live tensors in place)
    snap0 = None
    if rail is not None:
        snap0 = {k: v.detach().clone() for k, v in ckpt_lib.unnest(
            ckpt_lib.state_tree(model, state)).items()}
    # the pipeline retires in dispatch order: (step, seeds, key) of each
    # batch in flight, for the guard rail
    pending_meta: deque = deque()

    def drain_replays():
        for idx, rm in engine.replayed:
            if idx is not None:
                device_history[idx] = {**device_history[idx],
                                       **scalars(rm)}
        engine.replayed.clear()

    def scalars(m):
        """The history keeps scalar metrics: the mesh step's frontier
        tensors would pin memory for the whole run."""
        return {k: v for k, v in m.items() if k != "frontiers"}

    def absorb(done):
        """Fold the driver's retired batches into the history (in tag
        order) and, guarded, their flags into the rail."""
        nonlocal m
        for dtag, dm in done:
            device_history.append({"step": start_step + dtag + 1,
                                   **scalars(dm)})
            m = dm
            if rail is not None:
                ps, pseeds, pkey = pending_meta.popleft()
                due = rail.record(ps, pseeds, pkey, dm["guard_flags"])
                if due is not None:
                    recover(due)  # may raise _Rollback
        drain_replays()

    class _Rollback(Exception):
        """Unwinds the loop to the restored step."""

        def __init__(self, resume: int):
            self.resume = resume

    def recover(w):
        """A flagged batch: quarantine re-draws under fresh salts,
        escalating to (or, mode "rollback", starting at) a rollback."""
        nonlocal state, m
        if guard_cfg.mode == "quarantine":
            def attempt(i):
                nonlocal state, m
                rail.stats.quarantines += 1
                qk = quarantine_key(w.key, i)
                _, s2, m2 = engine.step(model, state, data, w.seeds, qk,
                                        tag=None)
                # resolve the re-draw now: its overflow replay, its flags
                _, s2, rm = engine.flush(model, s2, data)
                drain_replays()
                state = s2
                if rm is not None:
                    m2 = rm
                if bool(m2["guard_flags"].any()):
                    return None
                m = m2
                idx = w.step - start_step
                if 0 <= idx < len(device_history):
                    device_history[idx] = {"step": w.step + 1,
                                           **scalars(m2)}
                return m2
            try:
                guard_cfg.quarantine_policy().run(
                    attempt, error=GuardFault,
                    describe=f"quarantined batch at step {w.step} kept "
                             "faulting under fresh salts")
                return
            except GuardFault:
                pass  # every re-draw faulted: escalate to rollback
        do_rollback()

    def do_rollback():
        """Restore the last verified checkpoint (or the starting state)
        and unwind the loop to resume from it. The grown caps are kept:
        the sampled sets do not depend on them."""
        nonlocal state
        rail.stats.rollbacks += 1
        if rail.stats.rollbacks > guard_cfg.max_rollbacks:
            raise GuardFault(
                f"rollback budget exhausted ({guard_cfg.max_rollbacks}): "
                "faults persisted across restores")
        if saver is not None:
            saver.wait()  # the save in flight lands (or raises) first
        if mesh is not None and cfg.ckpt_dir:
            mesh.psum(torch.zeros(1, device=mesh.device))  # a barrier
        good = (ckpt_lib.latest_good_step(cfg.ckpt_dir)
                if cfg.ckpt_dir else None)
        if good is None or good < start_step:
            tree = ckpt_lib.nest({k: v.clone() for k, v in snap0.items()})
            resume = start_step
        else:
            tree = restore_tree(good)
            resume = good
        state = ckpt_lib.load_state_tree(
            model, dataclasses.replace(
                state, guard=init_guard_state(engine.device)), tree)
        rail.reset()
        engine.replayed.clear()
        pending_meta.clear()
        if driver is not None:
            driver.reset()
        else:
            engine.reset_protocol()
        del device_history[max(resume - start_step, 0):]
        raise _Rollback(resume)

    def heal():
        """Drain the rail (before a save, at the end) so no flagged batch
        is saved or left unresolved."""
        if rail is None:
            return
        while True:
            due = rail.flush()
            if due is None:
                return
            recover(due)

    def ckpt_meta():
        return {"loss": float(m["loss"]),
                **ckpt_lib.engine_restore_meta(
                    engine.sampler, mesh_devices=cfg.mesh_devices,
                    grad_compression=cfg.grad_compression,
                    backend=engine.backend)}

    def train_step(step):
        """Dispatch step ``step``'s batch on the configured path."""
        nonlocal model, state, m
        seeds = batches.at(step)
        sk = rng_lib.fold_in(base_key, step)
        data_t = (inject_lib.poison_batch(plan, step, data)
                  if plan is not None else data)
        if driver is not None:
            # tag: the history index this batch retires into
            tag = len(device_history) + driver.in_flight
            if rail is not None:
                pending_meta.append((step, seeds, sk))
            model, state, done = driver.step(model, state, data_t, seeds,
                                             sk, tag=tag)
            absorb(done)
        elif cfg.fused:
            model, state, m = engine.step(model, state, data_t, seeds, sk,
                                          tag=len(device_history))
            device_history.append({"step": step + 1, **scalars(m)})
            drain_replays()
            if rail is not None:
                due = rail.record(step, seeds, sk, m["guard_flags"])
                if due is not None:
                    recover(due)
        else:
            # as in the reference, the unfused step reads the canonical
            # data: the batch injectors do not reach it
            blocks, smp = sample_with_retry(engine.sampler, data.graph,
                                            seeds, sk, stats,
                                            backend=engine.backend)
            engine.sampler = smp
            with torch.no_grad():
                bf = gather_feats(data.features, blocks[-1])
            model, opt, m = step_fn(model, state.opt, blocks, bf,
                                    seed_labels(data.labels, seeds))
            state = dataclasses.replace(state, opt=opt)
            device_history.append({
                "step": step + 1, "loss": m["loss"], "acc": m["acc"],
                "sampled_v": blocks[-1].num_next,
                "sampled_e": sum(b.num_edges for b in blocks)})

    def drain():
        """Retire what is in flight and replay a pending overflow."""
        nonlocal model, state, m
        if driver is not None:
            # queued batches have no update yet, and a gated no-op batch
            # must be replayed before its parameters are saved
            model, state, done = driver.flush(model, state, data)
            absorb(done)
        elif cfg.fused:
            model, state, rm = engine.flush(model, state, data)
            drain_replays()
            if rm is not None:
                m = rm

    def run():
        step = start_step
        while True:
            try:
                while step < cfg.steps:
                    if preemptor is not None:
                        preemptor.check(step)
                    train_step(step)
                    if cfg.ckpt_dir and (step + 1) % cfg.ckpt_every == 0:
                        drain()
                        heal()  # a flagged batch is recovered, never saved
                        if saver:
                            saver.save(step + 1,
                                       ckpt_lib.state_tree(model, state),
                                       meta=ckpt_meta())
                    step += 1
                drain()
                heal()
                return
            except _Rollback as r:
                step = r.resume

    t0 = time.time()
    m = {"loss": torch.zeros(())}
    try:
        run()
    except BaseException:
        # a preemption (or any fault) ends the run: the save in flight
        # lands first, so that a restart resumes from it
        if saver is not None:
            try:
                saver.wait()
            except Exception:  # the run's own exception is the one raised
                pass
        raise
    if engine.device.type == "cuda":
        torch.cuda.synchronize(engine.device)
    wall = time.time() - t0
    history = [{"step": int(r["step"]), "loss": float(r["loss"]),
                "acc": float(r["acc"]), "sampled_v": int(r["sampled_v"]),
                "sampled_e": int(r["sampled_e"])} for r in device_history]
    if saver:
        saver.save(cfg.steps, ckpt_lib.state_tree(model, state),
                   meta=ckpt_meta())
        saver.wait()
    out = {"params": model, "history": history, "stats": stats,
           "wall_time": wall, "sampler": engine.sampler}
    if rail is not None:
        out["guard_stats"] = rail.stats
    if plan is not None:
        out["inject_log"] = list(plan.log)
    return out


@torch.no_grad()
def evaluate_gnn(ds: GraphDataset, model, cfg: GNNTrainConfig,
                 idx: np.ndarray, batches: int = 8, key=None) -> float:
    """Sampled evaluation accuracy on ``idx`` vertices; keys from
    ``key(1234)`` by ``split``, as in the reference."""
    engine = TrainEngine(build_sampler(ds, cfg), device=cfg.device)
    data = engine.make_data_from_dataset(ds)
    sampler = engine.sampler
    key = key if key is not None else rng_lib.key(1234)
    correct = total = 0
    for i in range(batches):
        lo = i * cfg.batch_size
        if lo >= len(idx):
            break
        chunk = np.asarray(idx[lo:lo + cfg.batch_size])
        seeds = pad_seeds(chunk, cfg.batch_size, device=engine.device)
        key, sk = rng_lib.split(key)
        blocks, sampler = sample_with_retry(sampler, data.graph, seeds, sk,
                                            backend=engine.backend)
        logits = model(blocks, gather_feats(data.features, blocks[-1]),
                       backend=engine.backend)
        pred = torch.argmax(logits, -1)[:len(chunk)].cpu().numpy()
        correct += int((pred == np.asarray(ds.labels)[chunk]).sum())
        total += len(chunk)
    return correct / max(total, 1)
