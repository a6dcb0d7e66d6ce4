"""Architecture registry of the LM side workload (twin of
``repro.configs``): ``get_config("<arch-id>")`` for each of the five
assigned architectures, plus the paper's own labor-gcn workloads
(``configs/labor_gcn.py``, the multi-device engine's configuration).

Shape-cell skips: long_500k needs sub-quadratic attention, so only the
SSM/hybrid archs run it; pure full-attention archs record a skip.
"""
from __future__ import annotations

from typing import List

from repro_torch.configs import (
    gemma2_2b,
    labor_gcn,
    mamba2_370m,
    qwen3_moe_235b_a22b,
    stablelm_1_6b,
    zamba2_2_7b,
)
from repro_torch.models.transformer.config import (  # noqa: F401
    LM_SHAPES,
    shape_by_name,
)

ARCHS = {
    "qwen3-moe-235b-a22b": qwen3_moe_235b_a22b.config,
    "mamba2-370m": mamba2_370m.config,
    "stablelm-1.6b": stablelm_1_6b.config,
    "gemma2-2b": gemma2_2b.config,
    "zamba2-2.7b": zamba2_2_7b.config,
}

GNN_ARCHS = {name: (labor_gcn.config, kw)
             for name, kw in labor_gcn.VARIANTS.items()}

# long_500k runs only for SSM/hybrid (sub-quadratic sequence mixing)
LONG_CONTEXT_OK = {"mamba2-370m", "zamba2-2.7b"}


def get_config(arch: str, **kw):
    if arch in ARCHS:
        return ARCHS[arch](**kw)
    if arch in GNN_ARCHS:
        fn, base = GNN_ARCHS[arch]
        return fn(**{**base, **kw})
    raise KeyError(f"unknown arch {arch!r}; known: "
                   f"{sorted(ARCHS) + sorted(GNN_ARCHS)}")


def cells_for(arch: str) -> List[dict]:
    """The shape cells of an arch: [{shape, run|skip, reason}]."""
    out = []
    for s in LM_SHAPES:
        if s.name == "long_500k" and arch not in LONG_CONTEXT_OK:
            out.append({"shape": s.name, "run": False,
                        "reason": "full attention is quadratic at 500k "
                                  "(DESIGN.md §Arch-applicability)"})
        else:
            out.append({"shape": s.name, "run": True, "reason": ""})
    return out


def all_lm_cells():
    """(arch, cell) for every registered LM arch and shape cell."""
    for arch in ARCHS:
        for cell in cells_for(arch):
            yield arch, cell
