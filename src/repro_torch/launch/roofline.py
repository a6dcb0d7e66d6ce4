"""The H100 roofline (twin of ``repro.launch.roofline``): the three
terms of a step, and the bytes and operations each kernel contract
needs.

Hardware model, one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates,
at the full 700 W power limit):

  HBM                         3.35 TB/s
  fp32 outside tensor cores   67 TFLOP/s   (the port's GEMMs: TF32 off)
  TF32 on the tensor cores    495 TFLOP/s
  3xTF32 (B9's products)      165 TFLOP/s  (495 over the 3 products)
  bf16 on the tensor cores    989 TFLOP/s
  NVLink                      450 GB/s each way

Terms (seconds), as the reference's:

  compute    = flops_per_device / peak   (the peak a caller names)
  memory     = bytes_per_device / HBM
  collective = wire_bytes_per_device / NVLink

The reference reads FLOPs and bytes from XLA's cost analysis and
collectives from the optimized HLO. The port has neither: the counts
come from each kernel contract's own work (:func:`compact` ...
:func:`flash_attention` below, functions of shapes and live counts
only, never of the backend that runs) and from the payloads the mesh
counted (:func:`collective_stats`). The reference's
``HLO_BYTES_CPU_INFLATION`` calibrates XLA's CPU byte count, which the
port does not have, so ``t_memory_s`` equals ``t_memory_raw_s``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, NamedTuple, Optional, Tuple

HBM_BW = 3.35e12
PEAK_FP32 = 67e12
PEAK_TF32 = 495e12
PEAK_TF32X3 = PEAK_TF32 / 3
PEAK_BF16 = 989e12
LINK_BW = 450e9

#: the peaks by the name a report gives them (the default, "fp32": the
#: port's GEMMs run in fp32 with TF32 off)
PEAKS = {"fp32": PEAK_FP32, "tf32": PEAK_TF32, "3xtf32": PEAK_TF32X3,
         "bf16": PEAK_BF16}


@dataclasses.dataclass
class CollectiveStats:
    wire_bytes: float = 0.0
    by_kind: Dict[str, float] = dataclasses.field(default_factory=dict)
    count: int = 0

    def add(self, kind: str, b: float):
        self.wire_bytes += b
        self.by_kind[kind] = self.by_kind.get(kind, 0.0) + b
        self.count += 1


def wire_bytes(kind: str, payload: float, group: int) -> float:
    """Per-device wire bytes of one collective under the ring model:
    all-reduce 2 (P-1)/P of the payload; all-gather, reduce-scatter and
    all-to-all (P-1)/P; a collective-permute the payload once. A group
    of one moves nothing."""
    p = int(group)
    if p <= 1:
        return 0.0
    if kind == "all-reduce":
        return 2.0 * (p - 1) / p * payload
    if kind in ("all-gather", "reduce-scatter", "all-to-all"):
        return (p - 1) / p * payload
    if kind == "collective-permute":
        return float(payload)
    raise ValueError(f"unknown collective {kind!r}")


def collective_stats(payloads: Iterable[Tuple[str, float, int]]
                     ) -> CollectiveStats:
    """Per-device wire bytes of counted collectives, each ``(kind,
    payload bytes, group size)``."""
    stats = CollectiveStats()
    for kind, payload, group in payloads:
        stats.add(kind, wire_bytes(kind, payload, group))
    return stats


def roofline_terms(flops_dev: float, bytes_dev: float, wire_bytes_dev: float,
                   by_kind: Optional[Dict[str, float]] = None, *,
                   model_flops_total: float = 0.0, chips: int = 1,
                   peak: str = "fp32") -> dict:
    """The reference's keys against the H100's peaks; ``peak`` names the
    compute rate the FLOPs divide by (a key of :data:`PEAKS`), and the
    result names it too. ``chips`` defaults to one card (the
    reference's to its 256-chip pod)."""
    peak_flops = PEAKS[peak]
    t_compute = flops_dev / peak_flops
    t_memory = bytes_dev / HBM_BW
    t_collective = wire_bytes_dev / LINK_BW
    terms = {"compute": t_compute, "memory": t_memory,
             "collective": t_collective}
    dominant = max(terms, key=terms.get)
    bound = max(terms.values())
    useful = model_flops_total / chips / peak_flops if model_flops_total \
        else 0.0
    return {
        "flops_per_device": flops_dev,
        "bytes_per_device": bytes_dev,
        "wire_bytes_per_device": wire_bytes_dev,
        "collectives_by_kind": by_kind or {},
        "t_compute_s": t_compute,
        "t_memory_raw_s": t_memory,
        "t_memory_s": t_memory,
        "t_collective_s": t_collective,
        "dominant": dominant,
        "step_time_lower_bound_s": bound,
        "model_flops_total": model_flops_total,
        "model_flops_per_device": model_flops_total / chips if chips else 0.0,
        "useful_flops_ratio": (model_flops_total / chips / flops_dev)
                              if flops_dev else 0.0,
        "roofline_fraction": (useful / bound) if bound else 0.0,
        "peak": peak, "peak_flops": peak_flops, "hbm_bw": HBM_BW,
        "link_bw": LINK_BW,
    }


def extrapolate_depth(v1: float, v2: float, repeats: int) -> float:
    """v(R) = v1 + (v2 - v1) (R - 1) from a 1-repeat and a 2-repeat
    count, at least 0: exact for depth-homogeneous stacks."""
    return max(v1 + (v2 - v1) * (repeats - 1), 0.0)


def model_flops(param_count: float, tokens: float, active_frac: float = 1.0,
                is_train: bool = True) -> float:
    """6 N D for training, 2 N D for a forward or a decode, N the active
    parameters."""
    mult = 6.0 if is_train else 2.0
    return mult * param_count * active_frac * tokens


# ---------------------------------------------------------------------------
# per-kernel work: each input byte read once, each output byte written
# once, and the operations the inputs need (``n`` is the live count)
# ---------------------------------------------------------------------------

class Work(NamedTuple):
    bytes: float
    flops: float = 0.0

    def __add__(self, other):
        return Work(self.bytes + other.bytes, self.flops + other.flops)

    def bound_ms(self, peak: float = PEAK_FP32) -> float:
        """The least time the card could take, in ms."""
        return max(self.bytes / HBM_BW, self.flops / peak) * 1e3


def compact(n: int, cap: int) -> Work:
    """The live flags read, ``cap`` slots and their mask written, the
    count."""
    return Work(n + cap * 5 + 4)


def hash_dedup(n: int, S: int, new_cap: int, E: int) -> Work:
    """The live values and their mask, the seeds read; the new values,
    every edge's slot, the count and the overflow flag written (also a
    cache lookup: T values against C keys is ``hash_dedup(T, C, T,
    T)``)."""
    return Work(n * 5 + S * 4 + new_cap * 4 + E * 4 + 5)


def compact_perm(n: int, E: int) -> Work:
    """The live keys and their mask read, the permutation written."""
    return Work(n * 5 + E * 4)


def spmm(n: int, rows: int, S: int, F: int) -> Work:
    """Forward SpMM: the live edges' source slot, destination slot,
    weight and mask, each distinct source row once, the S output rows;
    a multiply-add per edge and feature."""
    return Work(n * 13 + rows * F * 4 + S * F * 4, 2.0 * n * F)


def spmm_t(n: int, rows: int, T: int, F: int) -> Work:
    """Transposed SpMM through ``src_perm``: the permutation besides the
    forward's edge fields, each distinct destination row once, the T
    output rows."""
    return Work(n * 17 + rows * F * 4 + T * F * 4, 2.0 * n * F)


def gather_dst(n: int, rows: int, E: int, F: int) -> Work:
    """Per-edge destination rows: the live slots and mask, each distinct
    row once, all E output rows written."""
    return Work(n * 5 + rows * F * 4 + E * F * 4)


def scatter_rows(n: int, F: int, rows: int, perm: bool) -> Work:
    """Per-edge rows summed into ``rows`` rows: the live values, their
    index and mask (and the permutation), the output rows; an add per
    value."""
    return Work(n * F * 4 + n * (9 if perm else 5) + rows * F * 4,
                float(n * F))


def segment_select(n: int, S: int, E: int) -> Work:
    """The live keys and slots' bytes, each segment's start and take,
    the E-byte selection written."""
    return Work(n * 5 + S * 8 + E)


def masked_cdf_draw(C: int, n: int) -> Work:
    """B7's search: ``u`` and the draws once each, and one dependent
    4-byte CDF read per level of the binary search (``C.bit_length()``
    levels), at most the whole CDF."""
    probes = min(C, n * C.bit_length())
    return Work(8 * n + 4 * probes)


def edge_softmax(n: int, H: int, E: int) -> Work:
    """The live logits, slots and mask read once, every coefficient
    written once; per live logit two expf, two subtractions, an add and
    a division."""
    return Work(n * H * 4 + n * 5 + E * H * 4, 6.0 * n * H)


def visible_pairs(Sq: int, Sk: int, causal: bool,
                  window: Optional[int]) -> int:
    """(query, key) pairs the attention mask lets through, per head:
    query i sees keys [max(0, i - window + 1), hi] with hi = min(i, Sk -
    1) when causal, else Sk - 1."""
    total = 0
    for i in range(Sq):
        hi = min(i, Sk - 1) if causal else Sk - 1
        lo = max(i - window + 1, 0) if window is not None else 0
        total += max(hi - lo + 1, 0)
    return total


def flash_attention(B: int, Sq: int, Sk: int, Hq: int, Hkv: int, hd: int,
                    esize: int, causal: bool = True,
                    window: Optional[int] = None) -> Work:
    """B9: q, k, v read and the output written once; two products of
    ``hd`` per visible (query, key) pair and head."""
    pairs = visible_pairs(Sq, Sk, causal, window)
    return Work(esize * (2 * B * Sq * Hq * hd + 2 * B * Sk * Hkv * hd),
                4.0 * B * Hq * hd * pairs)


def gemm(m: int, k: int, n: int, esize: int = 4) -> Work:
    """An (m, k) x (k, n) product: both inputs read, the output written."""
    return Work(esize * (m * k + k * n + m * n), 2.0 * m * k * n)
