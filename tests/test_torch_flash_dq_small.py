"""The arithmetic of the port's bf16 K2 (dQ) at head dims 16 and 32
(``flash_bwd_dq_sm90`` in ``tpu_engine_torch/csrc/flash_bwd_sm90.cu``),
emulated in torch on the CPU in the kernel's order of operations and held
to the Pallas backward (``_flash_pallas._flash_bwd``, interpret mode) under
the bf16 bound of ``tests/test_flash_attention.py`` (atol 0.15, rtol 0.1)
and the card's relative norm bound (``REL["bf16"]`` 6e-3, ``chip_smoke.py``).

For each 64-key tile j the kernel takes S = Q K_jᵀ and dP = dO V_jᵀ from
bf16 operands with fp32 sums, P = 2^(S·scale·log2e − lse·log2e) (one fused
multiply-add against the row's lse·log2e), dS = P · (dP·scale − Δ·scale)
(one fused multiply-add against the row's −Δ·scale), zeroes dS where the
causal window hides a key, rounds dS to bf16 (the register A operand of
the next product) and adds dS K_j to dQ in fp32; dQ is rounded to bf16
once. Its inputs are the forward's lse and Δ = rowsum(dO ∘ O), as the
kernel receives them. Leaving one tile's dS·K out of dQ (the planted fault
``k2_d32_drop_k_tile`` of ``kernel_faults.py``) misses the relative norm
bound."""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from tpu_engine.ops import _flash_pallas  # noqa: E402
from tpu_engine_torch.ops import _flash_cuda  # noqa: E402

GRAD_TOL = dict(atol=0.15, rtol=0.1)  # tests/test_flash_attention.py's bf16 bound
REL_BF16 = 6e-3  # chip_smoke.REL["bf16"]: relative norm error on the card
LOG2E = 1.4426950408889634
TILE = 64  # keys of a streamed K/V tile
CASES = [(320, 0, True), (320, 37, True), (320, 0, False)]  # S, window, causal


def _fma(a, b, c):
    """fp32 a·b + c rounded once, as the kernel's FFMA."""
    return (a.double() * b.double() + c.double()).float()


def dq(q, k, v, do, lse, delta, window, causal, drop_last_tile=False):
    """K2 at D 16/32 tile by tile: q, k, v, do bf16 [BH, S, D]; lse, delta
    fp32 [BH, S]. ``drop_last_tile`` leaves each row's last visible key
    tile out of dQ."""
    S, D = q.shape[1:]
    scale = torch.tensor(1.0 / D ** 0.5, dtype=torch.float32)
    scale2 = scale * torch.tensor(LOG2E, dtype=torch.float32)
    nl = -(lse * torch.tensor(LOG2E, dtype=torch.float32))[..., None]
    nd = -(delta * scale)[..., None]
    vis = (_flash_cuda._visible(S, window, "cpu") if causal
           else torch.ones(S, S, dtype=torch.bool))
    last = (torch.arange(S) // TILE if causal else torch.full((S,), S // TILE - 1))
    qf, kf, vf, dof = (x.float() for x in (q, k, v, do))
    acc = torch.zeros(qf.shape, dtype=torch.float32)
    for j in range(S // TILE):
        keys = slice(j * TILE, (j + 1) * TILE)
        p = torch.exp2(_fma(qf @ kf[:, keys].transpose(-1, -2), scale2, nl))
        ds = p * _fma(dof @ vf[:, keys].transpose(-1, -2), scale, nd)
        keep = vis[:, keys] & ~(drop_last_tile & (last == j))[:, None]
        ds = ds.masked_fill(~keep, 0.0)
        acc += ds.bfloat16().float() @ kf[:, keys]
    return acc.bfloat16()


@functools.lru_cache(maxsize=None)
def _case(D, S, W, causal):
    """bf16 inputs from a numpy seed, the Pallas forward's (o, lse) and the
    Pallas backward's dq on them (interpret mode)."""
    rng = np.random.default_rng(21)
    x = [torch.tensor(rng.standard_normal((2, S, D)).astype(np.float32)).bfloat16()
         for _ in range(4)]
    jq, jk, jv, jdo = (jnp.asarray(t.float().numpy(), jnp.bfloat16) for t in x)
    block = _flash_pallas._pick_block(S)
    jo, jlse = _flash_pallas._flash_fwd(jq, jk, jv, block, True, W, causal=causal)
    jdq = _flash_pallas._flash_bwd(block, True, W, (jq, jk, jv, jo, jlse), jdo, causal)[0]
    o = torch.tensor(np.asarray(jo, np.float32)).bfloat16()
    lse = torch.tensor(np.asarray(jlse, np.float32))
    return x, o, lse, np.asarray(jdq, np.float32)


def _emulate(D, S, W, causal, drop_last_tile=False):
    (q, k, v, do), o, lse, want = _case(D, S, W, causal)
    got = dq(q, k, v, do, lse, _flash_cuda.flash_delta(o, do), W, causal, drop_last_tile)
    return got.float().numpy(), want


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("D", [16, 32])
@pytest.mark.parametrize("S,W,causal", CASES)
def test_dq_tile_order_matches_pallas(S, W, causal, D):
    got, want = _emulate(D, S, W, causal)
    np.testing.assert_allclose(got, want, **GRAD_TOL)
    assert _rel(got, want) <= REL_BF16


@pytest.mark.parametrize("D", [16, 32])
@pytest.mark.parametrize("S,W,causal", CASES)
def test_dq_missing_a_key_tile_misses_the_bound(S, W, causal, D):
    """The planted fault of ``kernel_faults.py`` (each row's last visible
    64-key tile left out of dQ) leaves the relative norm bound that the
    sound order keeps on the same inputs."""
    got, want = _emulate(D, S, W, causal, drop_last_tile=True)
    assert _rel(got, want) > REL_BF16
