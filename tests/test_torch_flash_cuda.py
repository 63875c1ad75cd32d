"""The port's CUDA flash-attention kernels against their plain PyTorch
versions, on the card. Skipped where there is no CUDA device.

On the GPU machine (which has no JAX, so the root conftest is skipped):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_flash_cuda.py -q
"""

import pytest

torch = pytest.importorskip("torch")

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


@pytest.mark.parametrize("bh,s,d,dtype,window", [
    (4, 128, 64, torch.bfloat16, 0), (4, 256, 128, torch.bfloat16, 0),
    (2, 256, 128, torch.bfloat16, 70), (2, 192, 64, torch.float32, 0),
    (2, 256, 128, torch.float32, 33),
])
def test_kernels_match_plain(cuda, bh, s, d, dtype, window):
    q, k, v, do = _inputs(bh, s, d, dtype)
    out_tol, grad_tol = TOL[dtype]
    o, lse = fc.flash_fwd(q, k, v, window)
    po, plse = fc.flash_fwd_plain(q, k, v, window)
    _assert_close(o, po, out_tol, REL[dtype])
    _assert_close(lse, plse, TOL[torch.float32][0], REL[torch.float32])
    got = fc.flash_bwd(q, k, v, o, lse, do, window)
    want = fc.flash_bwd_plain(q, k, v, po, plse, do, window)
    for a, b in zip(got, want):
        assert a.dtype == dtype
        _assert_close(a, b, grad_tol, REL[dtype])


def test_each_wrapper_counts_one_launch(cuda):
    q, k, v, do = _inputs(2, 128, 64, torch.bfloat16)
    fc.reset_launches()
    o, lse = fc.flash_fwd(q, k, v)
    fc.flash_bwd(q, k, v, o, lse, do)
    assert fc.launches == {"flash_fwd": 1, "flash_bwd_dq": 1, "flash_bwd_dkv": 1}


def test_autograd_through_mha_runs_the_kernels(cuda):
    g = torch.Generator(device="cuda").manual_seed(1)
    q, k, v = (torch.randn((2, 128, 4, 64), generator=g, device="cuda", dtype=torch.bfloat16)
               .requires_grad_(True) for _ in range(3))
    fc.reset_launches()
    tfa.mha(q, k, v).float().sum().backward()
    assert fc.launches == {"flash_fwd": 1, "flash_bwd_dq": 1, "flash_bwd_dkv": 1}
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
    small = torch.zeros((1, 64, 2, 16), device="cuda")
    with pytest.raises(tfa.FlashUnsupported):
        tfa.flash_mha(small, small, small)


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
