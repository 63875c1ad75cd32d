"""The port's CUDA flash-attention kernels against their plain PyTorch
versions, on the card. Skipped where there is no CUDA device.

On the GPU machine (which has no JAX, so the root conftest is skipped):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_flash_cuda.py -q
"""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from tpu_engine_torch.ops import _flash_cuda as fc  # noqa: E402
from tpu_engine_torch.ops import flash_attention as tfa  # noqa: E402

pytestmark = pytest.mark.cuda

TOL = {torch.bfloat16: (dict(atol=3e-2, rtol=3e-2), dict(atol=0.15, rtol=0.1)),
       torch.float32: (dict(atol=2e-5, rtol=2e-5), dict(atol=5e-4, rtol=5e-4))}
# The bf16 elementwise limits are as large as a typical output, so every
# output is also held by its relative norm error ||got - want|| / ||want||
# (bf16 rounding alone gives about 3e-3).
# lse is fp32 in every kernel and is held to fp32 limits.
REL = {torch.bfloat16: 6e-3, torch.float32: 1e-5}


def _assert_close(got, want, tol, rel):
    got, want = got.float(), want.float()
    torch.testing.assert_close(got, want, **tol)
    rel_err = float((got - want).norm() / want.norm())
    assert rel_err <= rel, f"relative norm error {rel_err:.3e} > {rel}"


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    fc.build()
    return torch.device("cuda")


def _inputs(bh, s, d, dtype, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn((bh, s, d), generator=g, device="cuda").to(dtype) for _ in range(4)]


@pytest.mark.parametrize("bh,s,d,dtype,window,causal", [
    (4, 128, 64, torch.bfloat16, 0, True), (4, 256, 128, torch.bfloat16, 0, True),
    (2, 256, 128, torch.bfloat16, 70, True), (2, 192, 64, torch.float32, 0, True),
    (2, 256, 128, torch.float32, 33, True),
    (4, 256, 128, torch.bfloat16, 0, False), (2, 192, 64, torch.float32, 0, False),
    (4, 256, 16, torch.bfloat16, 0, True), (4, 256, 32, torch.bfloat16, 0, False),
    (2, 128, 16, torch.float32, 0, False), (2, 192, 32, torch.float32, 40, True),
    # D 256 (gemma): causal, windowed and non-causal.
    (4, 256, 256, torch.bfloat16, 0, True), (2, 320, 256, torch.bfloat16, 37, True),
    (2, 192, 256, torch.bfloat16, 0, False), (2, 256, 256, torch.float32, 0, True),
    (2, 192, 256, torch.float32, 50, True), (2, 192, 256, torch.float32, 0, False),
])
def test_kernels_match_plain(cuda, bh, s, d, dtype, window, causal):
    q, k, v, do = _inputs(bh, s, d, dtype)
    out_tol, grad_tol = TOL[dtype]
    o, lse = fc.flash_fwd(q, k, v, window, causal)
    po, plse = fc.flash_fwd_plain(q, k, v, window, causal)
    _assert_close(o, po, out_tol, REL[dtype])
    _assert_close(lse, plse, TOL[torch.float32][0], REL[torch.float32])
    got = fc.flash_bwd(q, k, v, o, lse, do, window, causal)
    want = fc.flash_bwd_plain(q, k, v, po, plse, do, window, causal)
    for a, b in zip(got, want):
        assert a.dtype == dtype
        _assert_close(a, b, grad_tol, REL[dtype])


# The Hopper kernels (bf16: K1 at every head dim, K2 and K3 at D 16-128,
# K2 and K3 at 256) at the edges of their tiles: S 64, 192 and 320 (a
# ragged last 128-row tile, and at D 16 and 32 a ragged last 192-row owned
# tile of K2 and K3),
# causal and not; windows 37, 100, 128 and 200 at S 320 and 1024, through
# key tiles of 64 and 128 (and, at D 256, through the 32-key halves K2's
# warpgroups score); B·H 1 and 256.
_DIMS = (16, 32, 64, 128, 256)
_EDGES = ([(4, s, d, 0, c) for d in _DIMS for s in (64, 192, 320) for c in (True, False)]
          + [(2, s, d, w, True) for d in _DIMS for s in (320, 1024)
             for w in (37, 100, 128, 200)]
          + [(bh, 512, d, 0, c) for d in _DIMS for bh in (1, 256) for c in (True, False)])


@pytest.mark.parametrize("bh,s,d,window,causal", _EDGES)
def test_hopper_forward_at_tile_edges(cuda, bh, s, d, window, causal):
    q, k, v, _ = _inputs(bh, s, d, torch.bfloat16, seed=6)
    o, lse = fc.flash_fwd(q, k, v, window, causal)
    po, plse = fc.flash_fwd_plain(q, k, v, window, causal)
    _assert_close(o, po, TOL[torch.bfloat16][0], REL[torch.bfloat16])
    _assert_close(lse, plse, TOL[torch.float32][0], REL[torch.float32])


def test_hopper_forward_is_built_from_wgmma_and_tma(cuda):
    found = fc.sass_op_counts("flash_fwd_sm90", ("HGMMA", "UTMALDG"))
    assert len(found) == 10, found  # D 16, 32, 64, 128 and 256, causal and not
    assert all(n["HGMMA"] and n["UTMALDG"] for n in found.values()), found


def _bwd_args(bh, s, d, window, causal):
    """K2's and K3's inputs, with lse and Δ from the plain forward."""
    q, k, v, do = _inputs(bh, s, d, torch.bfloat16, seed=7)
    po, plse = fc.flash_fwd_plain(q, k, v, window, causal)
    return q, k, v, do, plse, fc.flash_delta(po, do), window, causal


@pytest.mark.parametrize("bh,s,d,window,causal", _EDGES)
def test_hopper_backward_at_tile_edges(cuda, bh, s, d, window, causal):
    args = _bwd_args(bh, s, d, window, causal)
    got = (fc.flash_bwd_dq(*args), *fc.flash_bwd_dkv(*args))
    want = (fc.flash_bwd_dq_plain(*args), *fc.flash_bwd_dkv_plain(*args))
    for a, b in zip(got, want):
        assert a.dtype == torch.bfloat16
        _assert_close(a, b, TOL[torch.bfloat16][1], REL[torch.bfloat16])


@pytest.mark.parametrize("d", [128, 32, 16])
@pytest.mark.parametrize("causal", [True, False])
def test_hopper_backward_is_deterministic(cuda, causal, d):
    """No atomics on gradients: two runs on the same inputs give
    bitwise-equal dQ, dK and dV."""
    args = _bwd_args(16, 1024, d, 0, causal)
    first = (fc.flash_bwd_dq(*args), *fc.flash_bwd_dkv(*args))
    second = (fc.flash_bwd_dq(*args), *fc.flash_bwd_dkv(*args))
    for a, b in zip(first, second):
        assert torch.equal(a.view(torch.int16), b.view(torch.int16))


@pytest.mark.parametrize("symbol,count", [
    ("flash_bwd_dq_sm90", 8),  # D 16, 32, 64 and 128, causal and not
    ("flash_bwd_dkv_sm90", 8),  # D 16, 32, 64 and 128, causal and not
    ("flash_bwd_dq_d256_sm90", 2), ("flash_bwd_dkv_d256_sm90", 2),  # D 256, causal and not
])
def test_hopper_backward_is_built_from_wgmma_and_tma(cuda, symbol, count):
    found = fc.sass_op_counts(symbol, ("HGMMA", "UTMALDG"))
    assert len(found) == count, found
    assert all(n["HGMMA"] and n["UTMALDG"] for n in found.values()), found


# fp32 K1, K2 and K3 (csrc/flash_f32_tc.cu, split TF32) at every head dim,
# causal, windowed (the window cuts K1's 32-key, K2's 16-key and K3's
# 16-query streamed tiles) and non-causal; at D 256 the CTA's two column
# groups of K1 and K2 exchange partial scores.
_F32 = [(2, s, d, w, c) for d in (16, 32, 64, 128, 256)
        for s, w, c in ((256, 0, True), (320, 37, True), (192, 0, False))]


@pytest.mark.parametrize("bh,s,d,window,causal", _F32)
def test_fp32_forward_and_dkv_match_plain(cuda, bh, s, d, window, causal):
    q, k, v, do = _inputs(bh, s, d, torch.float32, seed=5)
    o, lse = fc.flash_fwd(q, k, v, window, causal)
    po, plse = fc.flash_fwd_plain(q, k, v, window, causal)
    _assert_close(o, po, TOL[torch.float32][0], REL[torch.float32])
    _assert_close(lse, plse, TOL[torch.float32][0], REL[torch.float32])
    args = (q, k, v, do, plse, fc.flash_delta(po, do), window, causal)
    for a, b in zip(fc.flash_bwd_dkv(*args), fc.flash_bwd_dkv_plain(*args)):
        _assert_close(a, b, TOL[torch.float32][1], REL[torch.float32])


@pytest.mark.parametrize("bh,s,d,window,causal", _F32)
def test_fp32_dq_matches_plain(cuda, bh, s, d, window, causal):
    q, k, v, do = _inputs(bh, s, d, torch.float32, seed=5)
    po, plse = fc.flash_fwd_plain(q, k, v, window, causal)
    args = (q, k, v, do, plse, fc.flash_delta(po, do), window, causal)
    _assert_close(fc.flash_bwd_dq(*args), fc.flash_bwd_dq_plain(*args), TOL[torch.float32][1],
                  REL[torch.float32])


@pytest.mark.parametrize("bh,s,d,causal", [(4, 2048, 128, True), (2, 2048, 256, False)])
def test_fp32_kernels_hold_the_bound_at_s2048(cuda, bh, s, d, causal):
    """K1, K2 and K3 in fp32 over 2048 positions: the tensor cores truncate
    the sums they accumulate, so one chain of products along the sequence
    drifts past the fp32 relative norm bound there (2.2e-5 on dK and dV on
    an H100); each streamed tile's sums are added in fp32 instead."""
    q, k, v, do = _inputs(bh, s, d, torch.float32, seed=9)
    o, lse = fc.flash_fwd(q, k, v, 0, causal)
    po, plse = fc.flash_fwd_plain(q, k, v, 0, causal)
    _assert_close(o, po, TOL[torch.float32][0], REL[torch.float32])
    _assert_close(lse, plse, TOL[torch.float32][0], REL[torch.float32])
    args = (q, k, v, do, plse, fc.flash_delta(po, do), 0, causal)
    got = (fc.flash_bwd_dq(*args), *fc.flash_bwd_dkv(*args))
    want = (fc.flash_bwd_dq_plain(*args), *fc.flash_bwd_dkv_plain(*args))
    for a, b in zip(got, want):
        _assert_close(a, b, TOL[torch.float32][1], REL[torch.float32])


@pytest.mark.parametrize("symbol", ["flash_fwd_f32_tc", "flash_bwd_dq_f32_tc",
                                    "flash_bwd_dkv_f32_tc"])
def test_fp32_kernels_multiply_in_tf32_on_the_tensor_cores(cuda, symbol):
    """Every instantiation (D 16-256, causal and not) is built from TF32
    mma.sync (``HMMA.1688.F32.TF32``, and no HMMA of another kind), and
    ptxas reports no spill."""
    found = fc.sass_op_counts(symbol, ("HMMA.1688.F32.TF32", "HMMA"))
    assert len(found) == 10, found
    assert all(n["HMMA.1688.F32.TF32"] and n["HMMA.1688.F32.TF32"] == n["HMMA"]
               for n in found.values()), found
    regs = {n: v for n, v in fc.ptxas_table(fc.build_log()).items() if symbol in n}
    assert len(regs) == 10 and not any(v.get("spill_bytes") for v in regs.values()), regs


@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("causal", [True, False])
def test_fp32_dkv_is_deterministic(cuda, d, causal):
    """fp32 K3 writes each dK and dV row once and K2 each dQ row (no
    atomics; at D 256 both column groups of K2 add the exchanged partial
    scores in one order): two runs give bitwise-equal results."""
    q, k, v, do = _inputs(4, 512, d, torch.float32, seed=8)
    po, plse = fc.flash_fwd_plain(q, k, v, 0, causal)
    args = (q, k, v, do, plse, fc.flash_delta(po, do), 0, causal)
    first, second = ((fc.flash_bwd_dq(*args), *fc.flash_bwd_dkv(*args)) for _ in range(2))
    for a, b in zip(first, second):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


def _counts(**nonzero):
    return {name: nonzero.get(name, 0) for name in fc.launches}


def test_each_wrapper_counts_one_launch(cuda):
    q, k, v, do = _inputs(2, 128, 64, torch.bfloat16)
    fc.reset_launches()
    o, lse = fc.flash_fwd(q, k, v)
    fc.flash_bwd(q, k, v, o, lse, do)
    assert fc.launches == _counts(flash_fwd=1, flash_bwd_dq=1, flash_bwd_dkv=1)
    fc.reset_launches()
    o, lse = fc.flash_fwd(q, k, v, causal=False)
    fc.flash_bwd(q, k, v, o, lse, do, causal=False)
    assert fc.launches == _counts(flash_fwd_full=1, flash_bwd_dq_full=1, flash_bwd_dkv_full=1)


def test_autograd_through_mha_runs_the_kernels(cuda):
    g = torch.Generator(device="cuda").manual_seed(1)
    q, k, v = (torch.randn((2, 128, 4, 64), generator=g, device="cuda", dtype=torch.bfloat16)
               .requires_grad_(True) for _ in range(3))
    fc.reset_launches()
    tfa.mha(q, k, v).float().sum().backward()
    assert fc.launches == _counts(flash_fwd=1, flash_bwd_dq=1, flash_bwd_dkv=1)
    assert all(t.grad is not None and torch.isfinite(t.grad).all() for t in (q, k, v))


def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    q, k, v, _ = _inputs(2, 128, 64, torch.bfloat16)
    with pytest.raises(ValueError, match="contiguous"):
        fc.flash_fwd(q, k.transpose(1, 2).contiguous().transpose(1, 2), v)
    with pytest.raises(TypeError):
        fc.flash_fwd(q.half(), k.half(), v.half())
    with pytest.raises(ValueError, match="multiple"):
        fc.flash_fwd(q[:, :100].contiguous(), k[:, :100].contiguous(), v[:, :100].contiguous())
    with pytest.raises(ValueError):
        fc.flash_fwd(q, k.float(), v)
    untileable = torch.zeros((1, 100, 2, 16), device="cuda")
    with pytest.raises(tfa.FlashUnsupported):
        tfa.flash_mha(untileable, untileable, untileable)


def test_head_backward_keeps_the_fp32_cotangent(cuda):
    from tpu_engine_torch.models import transformer as tfm

    g = torch.Generator(device="cuda").manual_seed(3)
    x = torch.randn((256, 512), generator=g, device="cuda").bfloat16()
    w = (0.02 * torch.randn((512, 4096), generator=g, device="cuda")).bfloat16()
    dy = 1e-4 * torch.randn((256, 4096), generator=g, device="cuda")
    dx, dw = tfm._head_grads_f32(x, w, dy)
    for got, want in ((dx, dy @ w.float().t()), (dw, x.float().t() @ dy)):
        assert got.dtype == torch.float32
        assert float((got - want).norm() / want.norm()) <= 1e-4


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("causal", [True, False])
def test_lse_backward_matches_autograd_of_plain(cuda, causal, dtype):
    q, k, v, do = _inputs(2, 256, 64, dtype)
    dlse = torch.randn((2, 256), generator=torch.Generator(device="cuda").manual_seed(9),
                       device="cuda")
    xs = [t.clone().requires_grad_(True) for t in (q, k, v)]
    got = torch.autograd.grad(fc.flash_fwd_lse(*xs, causal=causal), xs, (do, dlse))
    ys = [t.clone().requires_grad_(True) for t in (q, k, v)]
    want = torch.autograd.grad(fc.flash_fwd_plain(*ys, causal=causal), ys, (do, dlse))
    for a, b in zip(got, want):
        _assert_close(a, b, TOL[dtype][1], REL[dtype])


def test_unbuilt_head_dim_raises_instead_of_the_plain_path(cuda):
    x = torch.zeros((1, 128, 2, 80), device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim=80"):
        tfa.mha(x, x, x)
    with pytest.raises(ValueError, match="head_dim=80"):
        fc.flash_fwd(x[0].transpose(0, 1).contiguous(), x[0].transpose(0, 1).contiguous(),
                     x[0].transpose(0, 1).contiguous())


def test_d256_backward_is_deterministic(cuda):
    """At D 256, K2 splits dQ's columns over two warpgroups of one CTA,
    which exchange dS through shared memory, and K3 splits dK and dV over
    two, which hand P^T over; neither uses atomics, so two runs give
    bitwise-equal gradients."""
    args = _bwd_args(8, 512, 256, 0, True)
    first = (fc.flash_bwd_dq(*args), *fc.flash_bwd_dkv(*args))
    second = (fc.flash_bwd_dq(*args), *fc.flash_bwd_dkv(*args))
    for a, b in zip(first, second):
        assert torch.equal(a.view(torch.int16), b.view(torch.int16))


@pytest.mark.parametrize("bh,s,window,causal", [
    (1, 512, 0, True), (1, 512, 0, False), (256, 512, 0, True), (256, 512, 0, False),
    (2, 512, 100, True),  # the window's edge cuts the 32-key halves of streamed tiles
])
def test_d256_dq_matches_plain(cuda, bh, s, window, causal):
    """K2 at D 256 alone against ``flash_bwd_dq_plain``: one head (a grid
    of few CTAs), 256 heads (more owned tiles than SMs, in chunks of heads),
    and a window whose edge falls inside the 32-key half of a streamed tile
    that each of the two warpgroups scores."""
    args = _bwd_args(bh, s, 256, window, causal)
    fc.reset_launches()
    got = fc.flash_bwd_dq(*args)
    assert fc.launches == _counts(**{"flash_bwd_dq" if causal else "flash_bwd_dq_full": 1})
    _assert_close(got, fc.flash_bwd_dq_plain(*args), TOL[torch.bfloat16][1], REL[torch.bfloat16])


def test_ring_launches_diagonal_causal_and_past_full(cuda):
    from tpu_engine_torch.parallel.ring_attention import ring_mha

    g = torch.Generator(device="cuda").manual_seed(2)
    q, k, v = (torch.randn((1, 512, 4, 64), generator=g, device="cuda", dtype=torch.bfloat16)
               .requires_grad_(True) for _ in range(3))
    fc.reset_launches()
    ring_mha(q, k, v, sequence=4).float().sum().backward()
    assert fc.launches == _counts(flash_fwd=4, flash_fwd_full=6, flash_bwd_dq=4,
                                  flash_bwd_dq_full=6, flash_bwd_dkv=4, flash_bwd_dkv_full=6)


def test_batch_one_heads_reach_the_kernels_contiguous(cuda):
    g = torch.Generator(device="cuda").manual_seed(4)
    q, k, v = (torch.randn((1, 128, 2, 16), generator=g, device="cuda").requires_grad_(True)
               for _ in range(3))
    out = tfa.flash_mha(q, k, v)
    want = tfa.mha(q, k, v, force_xla=True)
    _assert_close(out, want, TOL[torch.float32][0], REL[torch.float32])
