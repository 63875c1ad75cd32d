"""The split-TF32 arithmetic of the port's fp32 flash kernels, K1, K2 and K3
(``tpu_engine_torch/csrc/flash_f32_tc.cu``, ``csrc/tf32_split.cuh``),
emulated in torch on the CPU and held to the Pallas kernels in interpret
mode under the fp32 bounds of ``tests/test_flash_attention.py``: forward
2e-5, backward 5e-4.

Each fp32 operand x is split into hi = tf32(x), rounded to nearest with
ties away from zero (``cvt.rna.tf32.f32``; here ``(bits + 0x1000) &
~0x1FFF`` on the int32 view: the kernels add 0x1000 and the tensor cores
drop the low 13 bits), and lo = x - hi truncated to TF32 towards zero (the
kernels pass x - hi whole and the tensor cores drop its low bits), and
each product is lo_a·hi_b + hi_a·lo_b + hi_a·hi_b in fp32, the small terms
first. The forward is (o, lse) from such products; K2's piece
is dQ = dS·K from S = Q·Kᵀ and dP = dO·Vᵀ; K3's are dV = Pᵀ·dO and
dK = dSᵀ·Q from Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ; both on the forward's lse and
Δ = rowsum(dO ∘ O), as the kernels receive them. The kernels take the
softmax online, tile by tile; the emulation takes it whole, which is the
same function in fp32. Nor does the emulation see the tensor cores'
truncated sums along a long sequence: the kernels add each streamed tile's
sums in fp32, and only the card tests at S 2048 hold that.

The same emulation with hi_a·hi_b alone is plain TF32: it misses the
forward's bound by 12-55 times and the card's relative norm bound
(``REL["fp32"]`` 1e-5, ``chip_smoke.py``) by 36-60 times on o, dK and dV,
and by 52-59 times on dQ (the split reads 4.6-9.4e-7 there). The
elementwise 5e-4 gradient bound alone would not always see it: non-causal
dV and dQ stay inside it (dV at 0.64-0.69 of the bound at these inputs)."""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from tpu_engine.ops import _flash_pallas  # noqa: E402
from tpu_engine_torch.ops import _flash_cuda  # noqa: E402

FWD_TOL = dict(atol=2e-5, rtol=2e-5)
GRAD_TOL = dict(atol=5e-4, rtol=5e-4)
REL_FP32 = 1e-5  # chip_smoke.REL["fp32"]: relative norm error on the card
CASES = [(192, 0, True), (192, 37, True), (192, 0, False)]  # S, window, causal


def tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32, to nearest with ties away from zero."""
    return ((x.contiguous().view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_trunc(x: torch.Tensor) -> torch.Tensor:
    """x truncated to TF32, towards zero: what a TF32 mma reads of it."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def mm(a: torch.Tensor, b: torch.Tensor, terms: int = 3) -> torch.Tensor:
    """a @ b as the kernels take it: three TF32 products (``terms=3``), or
    plain TF32 (``terms=1``)."""
    ah, bh = tf32(a), tf32(b)
    if terms == 1:
        return ah @ bh
    al, bl = tf32_trunc(a - ah), tf32_trunc(b - bh)
    return (al @ bh + ah @ bl) + ah @ bh


def _visible(S, window, causal):
    return _flash_cuda._visible(S, window, "cpu") if causal else torch.ones(S, S, dtype=bool)


def forward(q, k, v, window, causal, terms=3):
    """K1: (o, lse) of softmax(q kᵀ / √D) v."""
    scale = 1.0 / q.shape[-1] ** 0.5
    s = mm(q, k.transpose(-1, -2), terms) * scale
    s = s.masked_fill(~_visible(q.shape[1], window, causal), float("-inf"))
    lse = torch.logsumexp(s, dim=-1)
    return mm(torch.exp(s - lse[..., None]), v, terms), lse


def dq(q, k, v, do, lse, delta, window, causal, terms=3):
    """K2: dq, query-major: scores with rows queries, columns keys."""
    scale = 1.0 / q.shape[-1] ** 0.5
    s = mm(q, k.transpose(-1, -2), terms) * scale
    p = torch.exp(s - lse[..., None])
    p = p.masked_fill(~_visible(q.shape[1], window, causal), 0.0)
    dp = mm(do, v.transpose(-1, -2), terms)
    return mm(p * (dp - delta[..., None]) * scale, k, terms)


def dkv(q, k, v, do, lse, delta, window, causal, terms=3):
    """K3: (dk, dv), key-major: transposed scores, rows keys, columns
    queries."""
    scale = 1.0 / q.shape[-1] ** 0.5
    sT = mm(k, q.transpose(-1, -2), terms) * scale
    pT = torch.exp(sT - lse[:, None, :])
    pT = pT.masked_fill(~_visible(q.shape[1], window, causal).T, 0.0)
    dpT = mm(v, do.transpose(-1, -2), terms)
    dsT = pT * (dpT - delta[:, None, :]) * scale
    return mm(dsT, q, terms), mm(pT, do, terms)


@functools.lru_cache(maxsize=None)
def _case(D, S, W, causal):
    """Inputs from a numpy seed, and the Pallas kernels' (o, lse, dk, dv,
    dq) on them (interpret mode)."""
    rng = np.random.default_rng(20)
    q, k, v, do = (rng.standard_normal((2, S, D)).astype(np.float32) for _ in range(4))
    block = _flash_pallas._pick_block(S)
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    jo, jlse = _flash_pallas._flash_fwd(jq, jk, jv, block, True, W, causal=causal)
    jdq, jdk, jdv = _flash_pallas._flash_bwd(block, True, W, (jq, jk, jv, jo, jlse),
                                             jnp.asarray(do), causal)
    return (q, k, v, do), tuple(np.asarray(x) for x in (jo, jlse, jdk, jdv, jdq))


def _emulate(D, S, W, causal, terms):
    (q, k, v, do), (jo, jlse, *_) = _case(D, S, W, causal)
    tq, tk, tv, tdo = (torch.tensor(x) for x in (q, k, v, do))
    o, lse = forward(tq, tk, tv, W, causal, terms)
    bwd = (tq, tk, tv, tdo, torch.tensor(jlse), (tdo * torch.tensor(jo)).sum(-1), W, causal,
           terms)
    dk, dv = dkv(*bwd)
    return {"o": o.numpy(), "lse": lse.numpy(), "dk": dk.numpy(), "dv": dv.numpy(),
            "dq": dq(*bwd).numpy()}


def _want(D, S, W, causal):
    return dict(zip(("o", "lse", "dk", "dv", "dq"), _case(D, S, W, causal)[1]))


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def test_tf32_rounds_to_nearest_with_ties_away_from_zero():
    one = 1.0
    half_ulp = 2.0 ** -11  # half of TF32's ulp at 1
    x = torch.tensor([one + half_ulp, -(one + half_ulp), one + half_ulp - 2.0 ** -23,
                      one + 3 * half_ulp])
    want = torch.tensor([one + 2 * half_ulp, -(one + 2 * half_ulp), one, one + 4 * half_ulp])
    assert torch.equal(tf32(x), want)
    r = torch.randn(4096, generator=torch.Generator().manual_seed(0))
    hi = tf32(r)
    assert torch.equal(hi.view(torch.int32) & 0x1FFF, torch.zeros_like(r, dtype=torch.int32))
    lo = tf32(r - hi)
    assert float(((hi + lo - r).abs() / r.abs()).max()) <= 2.0 ** -21
    lo = tf32_trunc(r - hi)  # the kernels' lo
    assert float(((hi + lo - r).abs() / r.abs()).max()) <= 2.0 ** -20


@pytest.mark.parametrize("D", [64, 128, 256])
@pytest.mark.parametrize("S,W,causal", CASES)
def test_split_tf32_forward_matches_pallas(S, W, causal, D):
    got, want = _emulate(D, S, W, causal, terms=3), _want(D, S, W, causal)
    for name in ("o", "lse"):
        np.testing.assert_allclose(got[name], want[name], **FWD_TOL)


@pytest.mark.parametrize("D", [64, 128, 256])
@pytest.mark.parametrize("S,W,causal", CASES)
def test_split_tf32_dkv_matches_pallas(S, W, causal, D):
    got, want = _emulate(D, S, W, causal, terms=3), _want(D, S, W, causal)
    for name in ("dk", "dv"):
        np.testing.assert_allclose(got[name], want[name], **GRAD_TOL)
        assert _rel(got[name], want[name]) <= REL_FP32


@pytest.mark.parametrize("D", [64, 128, 256])
@pytest.mark.parametrize("S,W,causal", CASES)
def test_plain_tf32_misses_the_fp32_bounds(S, W, causal, D):
    """One TF32 product (hi·hi) where the kernels take three: o leaves the
    forward's elementwise bound, and o, dK and dV leave the card's relative
    norm bound, on the inputs the split passes."""
    got, want = _emulate(D, S, W, causal, terms=1), _want(D, S, W, causal)
    assert not np.allclose(got["o"], want["o"], **FWD_TOL)
    for name in ("o", "dk", "dv"):
        assert _rel(got[name], want[name]) > REL_FP32, name


@pytest.mark.parametrize("D", [64, 128, 256])
@pytest.mark.parametrize("S,W,causal", CASES)
def test_split_tf32_dq_matches_pallas(S, W, causal, D):
    got, want = _emulate(D, S, W, causal, terms=3), _want(D, S, W, causal)
    np.testing.assert_allclose(got["dq"], want["dq"], **GRAD_TOL)
    assert _rel(got["dq"], want["dq"]) <= REL_FP32


@pytest.mark.parametrize("D", [64, 128, 256])
@pytest.mark.parametrize("S,W,causal", CASES)
def test_plain_tf32_dq_misses_the_fp32_bound(S, W, causal, D):
    """One TF32 product where K2 takes three: dQ leaves the card's relative
    norm bound on the inputs the split passes."""
    got, want = _emulate(D, S, W, causal, terms=1), _want(D, S, W, causal)
    assert _rel(got["dq"], want["dq"]) > REL_FP32
