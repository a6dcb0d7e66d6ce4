"""Deterministic, seedable fault injection at the runtime's trust
boundaries (twin of ``repro.runtime.inject``).

A plan is a set of named injectors, each wired into one boundary,
firing at a declared index and consuming a declared count: a pure
function of the call sequence, so a faulted run replays bit for bit and
a recovered run can be held against an unfaulted one.

Spec grammar (``--inject`` on the launchers, or ``REPRO_INJECT``)::

    spec      := site [ "@" at ] [ ":" count ] [ "=" param ]
    plan      := spec ("," spec)*

    nan_grad@5            NaN-poison batch 5's features (NaN loss + grads)
    corrupt_feats@4=1e8   scale batch 4's features (loss spike)
    overflow_storm@3:2    force the overflow flags true for 2 polls
    torn_ckpt@1           truncate arrays.npz of the 2nd checkpoint write
    stall_stage@2=0.25    sleep 0.25 s in the firing stage dispatch

``at`` is local to the site: the trainer's step for the batch sites, the
save ordinal for the checkpoint sites, the batch ordinal for the serving
sites. A spec fires when its site is queried with ``index >= at`` and
consumes one count per firing query.

==================  ===================================================
``nan_grad``        train dispatch: features x NaN (guard [nonfinite])
``corrupt_feats``   train dispatch: features x ``param`` (default 1e8;
                    guard [spike])
``corrupt_labels``  train dispatch: labels rotated by one class
``overflow_storm``  overflow-flag read: flags forced true for ``count``
                    polls (the grow-and-replay path, to exhaustion)
``torn_ckpt``       checkpoint publish: ``arrays.npz`` truncated after
                    the write, before the rename (CRC must skip it)
``ckpt_error``      async checkpoint writer: OSError in the save thread
                    (raised again on ``wait()`` or the next ``save()``)
``stall_stage``     stage dispatch (pipeline sample, serving infer):
                    sleep ``param`` seconds
``cache_corrupt``   serving cache state: NaN-poisoned tables before the
                    firing batch (the cache-off fallback must recover)
``pump_death``      serving background loop: the pump thread killed by
                    a non-``Exception`` (the watchdog must restart it)
==================  ===================================================
"""
from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional, Tuple

import torch

ENV_VAR = "REPRO_INJECT"

#: site -> (trust boundary, default param): what the parser accepts; the
#: tests hold every entry to a recovery test
SITES: Dict[str, Tuple[str, float]] = {
    "nan_grad": ("train dispatch: NaN batch features", float("nan")),
    "corrupt_feats": ("train dispatch: scaled batch features", 1e8),
    "corrupt_labels": ("train dispatch: rotated batch labels", 1.0),
    "overflow_storm": ("overflow-flag read: forced TRUE", 1.0),
    "torn_ckpt": ("checkpoint publish: truncated arrays.npz", 0.5),
    "ckpt_error": ("async checkpoint writer: raised OSError", 1.0),
    "stall_stage": ("stage dispatch: injected sleep", 0.05),
    "cache_corrupt": ("serving cache state: NaN value table", float("nan")),
    "pump_death": ("serving pump thread: killed", 1.0),
}


class InjectedThreadDeath(BaseException):
    """Raised by ``pump_death``. Not an ``Exception``: it stands for a
    failure the pump loop's own handler cannot see (a crash in native
    code), so it escapes the loop and the watchdog must recover."""


@dataclasses.dataclass
class InjectorSpec:
    """One armed injector: fires on queries with ``index >= at`` until
    ``count`` firings are consumed."""
    site: str
    at: int = 2
    count: int = 1
    param: Optional[float] = None
    fired: int = 0

    @property
    def effect(self) -> float:
        return SITES[self.site][1] if self.param is None else self.param

    @property
    def exhausted(self) -> bool:
        return self.fired >= self.count


class FaultPlan:
    """A parsed set of armed injectors, handed to each runtime surface.
    ``fires(site, index)`` is the one query point: it returns the spec
    (consuming one count) when an armed injector matches, else None;
    ``log`` records every firing as ``(site, index)``."""

    def __init__(self, specs: List[InjectorSpec]):
        self.specs = specs
        self.log: List[Tuple[str, int]] = []

    def __bool__(self) -> bool:
        return bool(self.specs)

    def fires(self, site: str, index: int) -> Optional[InjectorSpec]:
        for s in self.specs:
            if s.site == site and not s.exhausted and index >= s.at:
                s.fired += 1
                self.log.append((site, index))
                return s
        return None

    def armed(self, site: str) -> bool:
        """Whether a non-exhausted injector targets ``site``."""
        return any(s.site == site and not s.exhausted for s in self.specs)

    def all_fired(self) -> bool:
        return all(s.exhausted for s in self.specs)

    def describe(self) -> List[str]:
        return [f"{s.site}@{s.at}:{s.count}"
                + ("" if s.param is None else f"={s.param:g}")
                + f" [{s.fired}/{s.count} fired]" for s in self.specs]


def parse(text: Optional[str]) -> Optional[FaultPlan]:
    """Parse a plan spec string (see the module docstring). None for
    empty input; ``ValueError`` on an unknown site or a malformed
    spec."""
    if not text or not text.strip():
        return None
    specs = []
    for raw in text.split(","):
        raw = raw.strip()
        if not raw:
            continue
        body, param = raw.split("=", 1) if "=" in raw else (raw, None)
        body, count = body.split(":", 1) if ":" in body else (body, None)
        site, at = body.split("@", 1) if "@" in body else (body, None)
        site = site.strip()
        if site not in SITES:
            raise ValueError(
                f"unknown injector {site!r}; registered sites: "
                f"{', '.join(sorted(SITES))}")
        try:
            spec = InjectorSpec(
                site=site,
                at=int(at) if at is not None else 2,
                count=int(count) if count is not None else 1,
                param=float(param) if param is not None else None)
        except ValueError as e:
            raise ValueError(f"malformed injector spec {raw!r}: {e}") from e
        if spec.at < 0 or spec.count < 1:
            raise ValueError(f"injector spec {raw!r}: at must be >= 0 "
                             "and count >= 1")
        specs.append(spec)
    return FaultPlan(specs) if specs else None


def plan_from_env() -> Optional[FaultPlan]:
    """Parse ``$REPRO_INJECT``."""
    return parse(os.environ.get(ENV_VAR))


def poison_batch(plan: Optional[FaultPlan], step: int, data):
    """Apply any armed train-dispatch injector to step ``step``'s
    ``EngineData``: returns new data whose features or labels are
    poisoned for this one dispatch. ``data`` itself is never changed."""
    if plan is None:
        return data
    out = data
    spec = plan.fires("nan_grad", step)
    if spec is not None:
        out = dataclasses.replace(out, features=out.features * float("nan"))
    spec = plan.fires("corrupt_feats", step)
    if spec is not None:
        out = dataclasses.replace(out, features=out.features * torch.tensor(
            spec.effect, dtype=out.features.dtype,
            device=out.features.device))
    spec = plan.fires("corrupt_labels", step)
    if spec is not None:
        n_cls = (int(out.labels.max()) + 1 if out.labels.numel() else 1)
        out = dataclasses.replace(out,
                                  labels=(out.labels + 1) % max(n_cls, 1))
    return out
