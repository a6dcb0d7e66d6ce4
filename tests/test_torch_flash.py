"""B9's plain version and the model's plain attention in repro_torch
against repro on the CPU (inputs from numpy with a seed):

  * ``kernels/flash_attention/ref.py::attention_ref`` against repro's
    oracle on the five shapes of ``tests/test_kernels_flash.py``, a
    custom scale, bf16, non-causal calls (ragged Sk, and queries that see
    no key), atol 2e-5 (the reference suite's fp32 bound; scores summed
    in another order);
  * ``layers._attend_flags`` against repro's with a small ``chunk_q``, so
    that its q-chunked branch runs;
  * the kernel's 3xTF32 tensor-core arithmetic, emulated in plain torch
    (TF32 rounding as ``cvt.rna``), against the plain version (2e-5) and
    fp64 (1e-4 relative L2), and 1xTF32's larger error beside it;
  * the kernel's tile plan as the wrapper mirrors it (``ops.PLANS``, the
    ``FLASH_PLAN`` lines of the source): shared memory within the SM's,
    TMA boxes within their swizzle, 16-byte strides of every scratch;
    the prologue's plain version: ``split_tf32`` on random and edge
    values, and ``prologue_ref``'s layout;
  * the wrapper: on the CPU it is the plain version; its autograd
    Function (the kernel forward, the plain version's gradient) driven on
    CPU tensors with the kernel launch replaced by the plain version,
    against ``jax.vjp`` of the oracle; its argument checks.

The kernel itself runs only on the card (``tests/test_torch_cuda.py``).
"""
import dataclasses
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs in parallel workers, and torch's
# OpenMP threads spinning against them slow every worker several-fold
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.configs.reduce import reduce_cfg as jreduce  # noqa: E402
from repro.kernels.flash_attention import ref as jflash_ref  # noqa: E402
from repro.models.transformer import layers as JL  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.configs.reduce import reduce_cfg as treduce  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fo  # noqa: E402
from repro_torch.kernels.flash_attention import ref as fr  # noqa: E402
from repro_torch.models.transformer import layers as TL  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402

# the shapes of repro's own kernel suite (tests/test_kernels_flash.py)
CASES = [
    dict(B=2, S=128, Hq=4, Hkv=2, hd=64, window=None, softcap=None),
    dict(B=1, S=256, Hq=4, Hkv=4, hd=32, window=96, softcap=None),
    dict(B=1, S=130, Hq=2, Hkv=1, hd=64, window=None, softcap=50.0),
    dict(B=2, S=256, Hq=8, Hkv=2, hd=16, window=64, softcap=30.0),
    dict(B=1, S=64, Hq=1, Hkv=1, hd=128, window=None, softcap=None),
]


def _mk(B, Sq, Hq, Hkv, hd, Sk=None, seed=0):
    rng = np.random.default_rng(seed)
    Sk = Sq if Sk is None else Sk
    return (rng.normal(size=(B, Sq, Hq, hd)).astype(np.float32),
            rng.normal(size=(B, Sk, Hkv, hd)).astype(np.float32),
            rng.normal(size=(B, Sk, Hkv, hd)).astype(np.float32))


def _both(arrays, dtype=np.float32, **kw):
    jd = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    td = torch.bfloat16 if dtype == "bf16" else torch.float32
    want = jflash_ref.attention_ref(*(jnp.asarray(a, jd) for a in arrays),
                                    **kw)
    got = fr.attention_ref(*(torch.from_numpy(a).to(td) for a in arrays),
                           **kw)
    return (got.float().numpy(), np.asarray(want.astype(jnp.float32)))


@pytest.mark.parametrize("case", CASES)
def test_attention_ref_matches_repro(case):
    arrays = _mk(case["B"], case["S"], case["Hq"], case["Hkv"], case["hd"],
                 seed=case["S"])
    kw = dict(causal=True, window=case["window"], softcap=case["softcap"])
    got, want = _both(arrays, **kw)
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)
    # on CPU tensors the wrapper is the plain version
    cpu = fo.flash_attention(*(torch.from_numpy(a) for a in arrays), True,
                             case["window"], case["softcap"], None)
    np.testing.assert_array_equal(cpu.numpy(), got)


@pytest.mark.parametrize("name,Sq,Sk,kw", [
    ("custom scale", 96, 96, dict(causal=True, window=17, softcap=20.0,
                                  scale=0.3)),
    ("non-causal", 130, 130, dict(causal=False)),
    ("non-causal, ragged Sk", 70, 333, dict(causal=False, softcap=50.0)),
    ("queries that see no key", 90, 20, dict(causal=False, window=8)),
    ("one query", 1, 200, dict(causal=True, window=1)),
])
def test_attention_ref_options_match_repro(name, Sq, Sk, kw):
    got, want = _both(_mk(2, Sq, 4, 2, 32, Sk=Sk, seed=Sq + Sk), **kw)
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)


def test_attention_ref_bf16_matches_repro():
    """repro's ``test_vs_oracle_bf16`` shape: both cast bf16 inputs to
    fp32 and round the output to bf16 once."""
    c = CASES[0]
    got, want = _both(_mk(c["B"], c["S"], c["Hq"], c["Hkv"], c["hd"],
                          seed=1), dtype="bf16", causal=True)
    np.testing.assert_allclose(got, want, atol=3e-2, rtol=0)


@pytest.mark.parametrize("arch,kind", [("gemma2-2b", "attn_local"),
                                       ("gemma2-2b", "attn_global"),
                                       ("stablelm-1.6b", "attn")])
def test_attend_flags_chunked_matches_repro(arch, kind):
    """The q-chunked branch (chunk 16 of S = 48, the reduced gemma2's
    window 16) and the direct one, against repro's, and against each
    other."""
    jcfg = jreduce(jconfigs.get_config(arch, dtype="float32"))
    tcfg = treduce(tconfigs.get_config(arch, dtype="float32"))
    window = tcfg.window if kind == "attn_local" else None
    q, k, v = _mk(2, 48, tcfg.n_heads, tcfg.n_kv_heads, tcfg.head_dim,
                  seed=5)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    for chunk in (16, 1024):
        want = JL._attend_flags(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), jcfg, causal=True,
                                window=window, chunk_q=chunk)
        got = TL._attend_flags(tq, tk, tv, tcfg, causal=True, window=window,
                               chunk_q=chunk)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                                   rtol=0)
    # the model's plain attention is the kernel's plain version
    direct = fr.attention_ref(tq, tk, tv, causal=True, window=window,
                              softcap=tcfg.attn_softcap,
                              scale=TL._scale(tcfg, tcfg.head_dim))
    np.testing.assert_allclose(got.numpy(), direct.numpy(), atol=2e-6,
                               rtol=0)


def _tf32(x):
    """Round float32 to TF32 as ``cvt.rna.tf32.f32`` does: add half an
    ulp of the 10-bit mantissa to the bits, clear the low 13 (ties away
    from zero)."""
    return ((x.contiguous().view(torch.int32) + 0x1000) & ~0x1FFF).view(
        torch.float32)


def _mm_tf32(a, b, passes):
    """a @ b the way the kernel's wgmma computes it: 3xTF32 sums
    a_small b_big + a_big b_small, then a_big b_big (each x split into
    big = tf32(x) and small = tf32(x - big)); 1xTF32 is a_big b_big."""
    a_big, b_big = _tf32(a), _tf32(b)
    if passes == 1:
        return a_big @ b_big
    a_small, b_small = _tf32(a - a_big), _tf32(b - b_big)
    return (a_small @ b_big + a_big @ b_small) + a_big @ b_big


def _attention_tf32(q, k, v, passes, causal=True, window=None,
                    softcap=None, scale=None):
    """The kernel's arithmetic in plain torch: both products in 3xTF32
    (or 1xTF32), the scale on the scores, the softcap, -1e30 masking, an
    unnormalised softmax divided by its row sum at the end."""
    B, Sq, Hq, hd = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    scale = scale if scale is not None else hd ** -0.5
    qg = q.reshape(B, Sq, Hkv, Hq // Hkv, hd).permute(0, 2, 3, 1, 4)
    kt = k.permute(0, 2, 3, 1)[:, :, None]            # (B, Hkv, 1, hd, Sk)
    s = _mm_tf32(qg, kt, passes) * scale
    if softcap is not None:
        s = torch.tanh(s / softcap) * softcap
    s = torch.where(fr.visible(Sq, Sk, causal, window, q.device), s,
                    torch.tensor(-1e30))
    p = torch.exp(s - s.amax(-1, keepdim=True))
    o = _mm_tf32(p, v.permute(0, 2, 1, 3)[:, :, None], passes)
    o = o / p.sum(-1, keepdim=True)
    return o.permute(0, 3, 1, 2, 4).reshape(B, Sq, Hq, hd)


@pytest.mark.parametrize("case", CASES)
def test_3xtf32_arithmetic_keeps_the_gates(case):
    """The kernel's 3xTF32 products, emulated, against the plain version
    within 2e-5 x max(1, max|v|) and against an fp64 recompute within
    the LM gate of 1e-4 relative L2; 1xTF32 (one product of the rounded
    operands) misses by far more, which is why the kernel splits."""
    q, k, v = (torch.from_numpy(a) for a in _mk(
        case["B"], case["S"], case["Hq"], case["Hkv"], case["hd"],
        seed=case["S"]))
    kw = dict(causal=True, window=case["window"], softcap=case["softcap"])
    plain = fr.attention_ref(q, k, v, **kw)
    f64 = fr.attention_ref(q.double(), k.double(), v.double(), **kw)
    tol = 2e-5 * max(1.0, v.abs().max().item())
    errs = {}
    for passes in (3, 1):
        got = _attention_tf32(q, k, v, passes, **kw)
        errs[passes] = ((got.double() - f64).norm() / f64.norm()).item()
        gap = (got - plain).abs().max().item()
        if passes == 3:
            assert gap <= tol and errs[3] <= 1e-4, (gap, errs)
        else:   # 1xTF32 fails the kernel's gate against the plain version
            assert gap > tol, gap
    assert errs[1] > 10 * errs[3], errs
    assert (_tf32(torch.tensor([1 + 2**-11, -(1 + 2**-11), 1 + 2**-12]))
            == torch.tensor([1 + 2**-10, -(1 + 2**-10), 1.0])).all()


def test_autograd_function_matches_jax_vjp(monkeypatch):
    """The cuda path's autograd Function on CPU tensors, its launch
    replaced by the plain version (counted): the forward and the
    gradients of q, k and v against ``jax.vjp`` of repro's oracle."""
    calls = []

    def fake_fwd(q, k, v, causal, window, softcap, scale):
        calls.append(q.shape)
        return fr.attention_ref(q, k, v, causal=causal, window=window,
                                softcap=softcap, scale=scale)

    monkeypatch.setattr(fo, "flash_attention_fwd", fake_fwd)
    q, k, v = _mk(2, 40, 4, 2, 16, seed=9)
    g = np.random.default_rng(10).normal(size=q.shape).astype(np.float32)
    kw = dict(causal=True, window=11, softcap=30.0, scale=None)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = fo._FlashAttention.apply(tq, tk, tv, *kw.values())
    out.backward(torch.from_numpy(g))
    want, vjp = jax.vjp(
        lambda a, b, c: jflash_ref.attention_ref(a, b, c, **kw),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    assert len(calls) == 1
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               atol=2e-5, rtol=0)
    for got, ref_g in zip((tq.grad, tk.grad, tv.grad), vjp(jnp.asarray(g))):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref_g),
                                   atol=1e-4, rtol=1e-4)


def test_wrapper_refuses_what_the_kernel_does_not_take():
    q, k, v = (torch.from_numpy(a) for a in _mk(1, 8, 4, 2, 16))
    with pytest.raises(ValueError, match="CUDA"):
        fo.flash_attention_fwd(q, k, v)
    with pytest.raises(TypeError, match="dtype"):
        fo._checked(q, k.double(), v)
    with pytest.raises(ValueError, match="multiple"):
        fo._checked(q[:, :, :3], k, v)
    with pytest.raises(ValueError, match="head dimension"):
        fo._checked(q[..., :12], k[..., :12], v[..., :12])
    with pytest.raises(ValueError, match="contiguous"):
        fo._checked(q.transpose(2, 3), k, v)
    # strided views (a slice of a fused qkv tensor) are taken as they are
    qkv = torch.zeros(1, 8, 3, 4, 16)
    assert fo._checked(qkv[:, :, 0], k, v) == (1, 8, 8, 4, 2, 16)


def _kernel_plans():
    """The ``FLASH_PLAN(T, HD, C, BK, DC, NS)`` lines of the kernel's
    source."""
    src = (_build.CSRC / "flash_attention.cu").read_text()
    out = {}
    for m in re.finditer(r"^FLASH_PLAN\((float|__nv_bfloat16), (\d+), "
                         r"(\d+), (\d+), (\d+), (\d+)\)", src, re.M):
        dt = torch.float32 if m.group(1) == "float" else torch.bfloat16
        out[(dt, int(m.group(2)))] = tuple(int(g) for g in m.groups()[2:])
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("hd", fo.HEAD_DIMS)
def test_tile_plan_fits_the_card(hd, dtype):
    """For every built (hd, dtype): the wrapper's plan is the source's;
    a block's shared memory fits the H100's 232,448 bytes; every TMA box
    has an inner extent within its swizzle width (a multiple of 16
    bytes) and at most 256 rows; every scratch row and plane is a
    multiple of 16 bytes at ragged lengths; the slabs tile hd and the
    k-steps of 32 bytes tile each swizzle row."""
    assert _kernel_plans()[(dtype, hd)] == fo.PLANS[(dtype, hd)]
    p = fo.plan(hd, dtype)
    e, parts = p["elem"], p["parts"]
    assert p["smem"] <= fo.SMEM_LIMIT
    assert p["smem"] == (1024 + p["BQ"] * hd * e * parts
                         + p["NS"] * p["BK"] * p["DC"] * e * parts + 256)
    for name, (inner, rows) in p["box"].items():
        sw = p["swizzle"][name]
        assert inner * e <= sw and (inner * e) % 16 == 0 and rows <= 256
        assert sw % 32 == 0          # a k-step (32 bytes) within a row
    assert hd % p["DC"] == 0 and p["DC"] % p["box"]["k"][0] == 0
    assert p["BK"] % p["box"]["vt"][0] == 0 and p["DC"] % 8 == 0
    assert (hd * e) % p["swizzle"]["q"] == 0 and p["swizzle"]["q"] == p[
        "swizzle"]["k"] == p["box"]["k"][0] * e
    for S in (1, 7, 8, 9, 63, 65, 416, 32768):
        for shape in fo.scratch_shapes(2, S, 4, hd, dtype):
            assert shape[2] == parts
            assert (shape[-1] * e) % 16 == 0           # row pitch
            assert (shape[-1] * shape[-2] * e) % 16 == 0   # plane pitch
        offsets, size = fo.scratch_layout(2, S, 4, hd, dtype)
        assert all(o * e % 256 == 0 for o in offsets) and size >= offsets[1]


EDGE_VALUES = {
    "random": lambda: torch.from_numpy(np.random.default_rng(3).normal(
        size=4096).astype(np.float32)) * torch.logspace(-30, 30, 4096),
    "ties": lambda: torch.tensor([1 + 2**-11, -(1 + 2**-11), 3 * 2**-12
                                  + 1, 1.5 + 2**-11, 2**-11, 0.0, -0.0]),
    "subnormals": lambda: torch.tensor(
        [1e-45, -1e-45, 2.5e-40, -1.17e-38, 5e-39, 1.1754942e-38]),
    "infinities": lambda: torch.tensor([float("inf"), -float("inf"),
                                        3.4028235e38, -3.4028235e38,
                                        3.39e38]),
}


@pytest.mark.parametrize("kind", list(EDGE_VALUES))
def test_split_tf32_keeps_fp32(kind):
    """The prologue's split: big rounds to nearest on the 13 low
    mantissa bits with ties away from zero (``cvt.rna``), so those bits
    of big and of small are 0, and big + small gives x back within
    2^-22 |x| (infinities exactly; a finite x past TF32's largest keeps
    its truncation as big; a subnormal within half the TF32 grid's step
    there, 2^-137, as TF32 holds no finer subnormal)."""
    x = EDGE_VALUES[kind]().float()
    big, small = fr.split_tf32(x)
    for part in (big, small):
        assert (part.view(torch.int32) & 0x1FFF == 0).all()
    assert torch.isfinite(big[torch.isfinite(x)]).all()
    xd, sd = x.double(), big.double() + small.double()
    fin = torch.isfinite(x)
    err = (xd[fin] - sd[fin]).abs()
    bound = torch.maximum(2.0**-22 * xd[fin].abs(),
                          torch.full_like(err, 2.0**-137))
    assert (err <= bound).all(), (x[fin][err > bound], err.max())
    assert torch.equal(sd[~fin], xd[~fin])
    if kind == "ties":   # ties round away from zero
        assert big[0] == 1 + 2**-10 and big[1] == -(1 + 2**-10)
        assert small[0] == -(2**-11) and big[4] == 2**-11


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_prologue_ref_layout(dtype):
    """``prologue_ref``: the shapes of ``scratch_shapes``; K's parts sum
    back to k (exactly for bf16's one part); V^T holds v transposed, fp32's
    keys in ``VT_PERM`` order within each 8, the keys past Sk zero."""
    B, Sk, Hkv, hd = 2, 13, 2, 16
    _, k, v = (torch.from_numpy(a).to(dtype)
               for a in _mk(B, 4, 4, Hkv, hd, Sk=Sk, seed=4))
    ks, vts = fr.prologue_ref(k, v)
    assert [tuple(t.shape) for t in (ks, vts)] == [
        tuple(s) for s in fo.scratch_shapes(B, Sk, Hkv, hd, dtype)]
    torch.testing.assert_close(ks.double().sum(2),
                               k.permute(0, 2, 1, 3).double(),
                               rtol=2.0**-22, atol=0)
    vt = vts.double().sum(2)                   # (B, Hkv, hd, Skp)
    skp = vt.shape[-1]
    assert skp == 16
    pos = torch.arange(skp)
    key = ((pos & ~7) | torch.tensor(fr.VT_PERM)[pos & 7]
           if dtype == torch.float32 else pos)
    want = torch.nn.functional.pad(v.permute(0, 2, 3, 1).double(),
                                   (0, skp - Sk))[..., key]
    torch.testing.assert_close(vt, want, rtol=2.0**-22, atol=0)
    assert sorted(fr.VT_PERM) == list(range(8))


def test_configs_match_repro():
    """get_config, reduce_cfg and cells_for: every field of the five
    archs equal to repro's, and of the labor-gcn workloads (the
    multi-device engine's configurations)."""
    assert sorted(tconfigs.ARCHS) == sorted(jconfigs.ARCHS)
    for arch in tconfigs.ARCHS:
        t, j = tconfigs.get_config(arch), jconfigs.get_config(arch)
        assert dataclasses.asdict(t) == dataclasses.asdict(j), arch
        assert (dataclasses.asdict(treduce(t))
                == dataclasses.asdict(jreduce(j))), arch
        assert tconfigs.cells_for(arch) == jconfigs.cells_for(arch)
    assert sorted(tconfigs.GNN_ARCHS) == sorted(jconfigs.GNN_ARCHS)
    for arch in tconfigs.GNN_ARCHS:
        assert (dataclasses.asdict(tconfigs.get_config(arch))
                == dataclasses.asdict(jconfigs.get_config(arch))), arch
    assert (dataclasses.asdict(tconfigs.get_config("labor-gcn",
                                                   global_batch=8))
            == dataclasses.asdict(jconfigs.get_config("labor-gcn",
                                                      global_batch=8)))
    with pytest.raises(KeyError):
        tconfigs.get_config("labor-gin")
