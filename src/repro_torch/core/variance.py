"""Analytic variance oracles from the paper, used by the test suite (twin
of ``repro.core.variance``).

All formulas assume Var(M_t) = 1 elementwise (paper §2), so that they
can be checked by Monte-Carlo over a sampler with iid unit-variance
feature vectors. Inputs are tensors or numbers; results are float32
tensors.
"""
from __future__ import annotations

import torch


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def ns_without_replacement_variance(d, k) -> torch.Tensor:
    """Var(H''_s) for exact-k uniform sampling without replacement
    (eq. 7): (d - k)/(d - 1) * 1/k, and 0 when k >= d."""
    d = _f32(d)
    k = torch.minimum(_f32(k), d)
    return torch.where(d > 1, (d - k) / (d - 1) / k, 0.0)


def poisson_ht_variance(pi_by_seed) -> torch.Tensor:
    """Var(H'_s) for Poisson sampling with inclusion probabilities pi
    (eq. 8): (1/d^2) sum 1/pi - 1/d, with ``pi_by_seed`` of shape [d]
    (one seed)."""
    pi = _f32(pi_by_seed)
    d = pi.shape[0]
    return torch.sum(torch.ones_like(pi) / pi) / d ** 2 - 1.0 / d


def poisson_uniform_variance(d, k) -> torch.Tensor:
    """eq. 8 at pi = k/d: 1/k - 1/d (the LABOR variance target, eq. 9)."""
    d, k = _f32(d), _f32(k)
    one = torch.ones_like(d * k)
    return torch.where(k >= d, 0.0, one / k - one / d)


def calibrated_target_matches_ns(d, k) -> torch.Tensor:
    """eq. 10: d/(d-1)*(1/k - 1/d) - (d-k)/(d-1)*(1/k) == 0."""
    d, k = _f32(d), _f32(k)
    one = torch.ones_like(d * k)
    return d / (d - 1) * (one / k - one / d) - (d - k) / (d - 1) / k
