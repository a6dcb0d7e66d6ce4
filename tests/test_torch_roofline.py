"""``repro_torch.launch.roofline`` against ``repro.launch.roofline`` on the
CPU: with the reference's peaks set to the H100's (monkeypatched, no
file edited) and its CPU byte calibration to 1, ``roofline_terms``
gives the reference's keys and values; the ring model gives the
reference's wire bytes on ``tests/test_roofline.py``'s HLO; the model
FLOPs and the depth extrapolation are the reference's exactly. The
per-kernel work functions keep the bounds chip_smoke.py printed before
they moved into the package. Tolerance: exact (the same float
expressions), stated per assertion."""
import math

import pytest
import torch

from repro.launch import roofline as jrl
from repro_torch.launch import roofline as rl

torch.set_num_threads(1)


@pytest.fixture
def h100_reference(monkeypatch):
    monkeypatch.setattr(jrl, "PEAK_FLOPS", rl.PEAK_FP32)
    monkeypatch.setattr(jrl, "HBM_BW", rl.HBM_BW)
    monkeypatch.setattr(jrl, "LINK_BW", rl.LINK_BW)
    monkeypatch.setattr(jrl, "HLO_BYTES_CPU_INFLATION", 1.0)
    return jrl


GRID = [(f, b, w, m, c)
        for f in (0.0, 1e9, 3.3e14)
        for b in (0.0, 2.5e8, 7e11)
        for w in (0.0, 4e7, 9e10)
        for m, c in ((0.0, 1), (2.56e17, 256), (5.1e12, 1), (8e14, 4))]


def test_roofline_terms_match_the_reference_key_for_key(h100_reference):
    for f, b, w, m, c in GRID:
        want = h100_reference.roofline_terms(
            f, b, w, {"all-to-all": w}, model_flops_total=m, chips=c)
        got = rl.roofline_terms(f, b, w, {"all-to-all": w},
                                model_flops_total=m, chips=c)
        for k, v in want.items():
            assert got[k] == v, (k, f, b, w, m, c)   # exact
        assert got["t_memory_s"] == got["t_memory_raw_s"]
        assert got["peak"] == "fp32" and got["peak_flops"] == 67e12


def test_named_peaks_divide_the_flops():
    t = rl.roofline_terms(165e12, 0.0, 0.0, peak="3xtf32")
    assert t["t_compute_s"] == pytest.approx(1.0, rel=1e-15)
    assert rl.PEAKS == {"fp32": 67e12, "tf32": 495e12, "3xtf32": 165e12,
                        "bf16": 989e12}


def _hlo_payloads():
    """(kind, payload bytes, group size) of every collective in
    test_roofline.py's HLO, read with the reference's own parsers."""
    from test_roofline import HLO
    out = []
    for line in HLO.splitlines():
        m = jrl._COLL_RE.search(line)
        if m:
            out.append((m.group(2), jrl._shape_bytes(m.group(1)),
                        jrl._group_size(line)))
    return HLO, out


def test_wire_bytes_match_the_reference_hlo_parse():
    hlo, payloads = _hlo_payloads()
    want = jrl.collective_wire_bytes(hlo)
    got = rl.collective_stats(payloads)
    assert set(got.by_kind) == set(want.by_kind)
    for kind, v in want.by_kind.items():
        assert got.by_kind[kind] == v, kind             # exact
    assert got.wire_bytes == want.wire_bytes and got.count == want.count


def test_one_device_moves_nothing():
    for kind in ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                 "collective-permute"):
        assert rl.wire_bytes(kind, 1e9, 1) == 0.0
    with pytest.raises(ValueError):
        rl.wire_bytes("broadcast", 1.0, 2)


def test_model_flops_and_depth_extrapolation_are_exact():
    for n, d, a, t in ((2.6e9, 4096.0, 1.0, True), (2.35e11, 2048.0,
                                                     0.094, False),
                       (0.0, 5.0, 0.5, True)):
        assert rl.model_flops(n, d, a, t) == jrl.model_flops(n, d, a, t)
    for v1, v2, r in ((5.0, 8.0, 24), (10.0, 8.0, 100), (1e12, 3e12, 94)):
        assert rl.extrapolate_depth(v1, v2, r) == \
            jrl.extrapolate_depth(v1, v2, r)


def test_kernel_work_keeps_the_chip_smoke_formulas():
    """The bounds chip_smoke.py computed inline before (the same
    integers, so the same floats)."""
    n, cap, S, new_cap, E, F, rows = 985_188, 9_426_304, 470_656, 612_352, \
        9_426_304, 256, 300_000
    assert rl.compact(n, cap).bytes == n + cap * 5 + 4
    assert rl.hash_dedup(n, S, new_cap, E).bytes == \
        n * 5 + S * 4 + new_cap * 4 + E * 4 + 5
    # the async driver's cache lookup: T values against C keys
    T, C = 1_083_008, 262_144
    assert rl.hash_dedup(T, C, T, T).bytes == T * 5 + C * 4 + T * 8 + 5
    assert rl.spmm(n, rows, S, F) == (n * 13 + rows * F * 4 + S * F * 4,
                                      2.0 * n * F)
    assert rl.spmm_t(n, rows, S, F) == (n * 17 + rows * F * 4 + S * F * 4,
                                        2.0 * n * F)
    assert rl.scatter_rows(n, F, rows, True).bytes == \
        n * F * 4 + n * 9 + rows * F * 4
    assert rl.masked_cdf_draw(10_240, 3) == (8 * 3 + 4 * min(
        10_240, 3 * (10_240).bit_length()), 0.0)
    w = rl.edge_softmax(n, 8, E)
    assert w.bound_ms() == max(w.bytes / 3.35e12, w.flops / 67e12) * 1e3


def test_visible_pairs_count_the_mask():
    for Sq, Sk, causal, window in ((130, 130, True, None), (7, 300, False,
                                                              None),
                                   (1000, 1000, True, 64), (1, 9, True, 1)):
        i = torch.arange(Sq)[:, None]
        j = torch.arange(Sk)[None, :]
        m = torch.ones(Sq, Sk, dtype=torch.bool)
        if causal:
            m &= j <= i
        if window is not None:
            m &= i - j < window
        assert rl.visible_pairs(Sq, Sk, causal, window) == int(m.sum())
    w = rl.flash_attention(1, 32768, 32768, 8, 4, 256, 4, True, None)
    assert w.flops == 4.0 * 8 * 256 * (32768 * 32769 // 2)
    assert math.isclose(w.bound_ms(rl.PEAK_TF32X3),
                        w.flops / 165e12 * 1e3, rel_tol=1e-15)
