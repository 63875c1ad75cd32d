"""Where the training state lives, on the card: the host placements in
pinned memory against the in-memory program, and the ``offload_dots``
remat policy against ``nothing_saveable``, bitwise. Skipped where there is
no CUDA device; the CPU side is tests/test_torch_offload.py and
tests/test_torch_remat.py.

On the GPU machine (which has no JAX, so the root conftest is skipped):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_offload_cuda.py -q
"""

import gc

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from tpu_engine_torch import offload  # noqa: E402
from tpu_engine_torch import train as ttrain  # noqa: E402
from tpu_engine_torch.models import config as tcfg  # noqa: E402
from tpu_engine_torch.models import transformer as ttfm  # noqa: E402
from tpu_engine_torch.ops import _flash_cuda as fc  # noqa: E402

pytestmark = pytest.mark.cuda

_KW = dict(model_name="gpt-tiny", micro_batch_size=2, gradient_accumulation_steps=2,
           seq_len=128, precision="bf16", learning_rate=1e-3, warmup_steps=1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (pinned memory and the flash kernels)")
    fc.build()
    return torch.device("cuda")


def _run(**extra):
    prog = ttrain.build_train_program(ttrain.TrainConfig(**{**_KW, **extra}), device="cuda")
    state = prog.init()
    batch = prog.synthetic_batch(0)
    losses = []
    for _ in range(3):
        state, m = prog.step(state, batch)
        losses.append(m["loss"])
    return prog, state, torch.stack(losses)


@pytest.mark.parametrize("extra", [dict(optimizer_offload="host"), dict(param_offload="host"),
                                   dict(optimizer_offload="host", param_offload="host"),
                                   dict(param_dtype="bf16", optimizer_offload="host",
                                        param_offload="host")],
                         ids=["optimizer", "params", "both", "bf16_masters"])
def test_host_placements_equal_in_memory_bitwise(cuda, extra):
    _, want, want_losses = _run(**{k: v for k, v in extra.items()
                                   if k not in ("optimizer_offload", "param_offload")})
    prog, got, losses = _run(**extra)
    assert torch.equal(losses, want_losses)
    for k, p in got["params"].items():
        assert torch.equal(p.to(cuda), want["params"][k]), k
    trees = [got["params"]] + [t for n, t in got["opt_state"].items() if n != "count"]
    host = [t for tree in trees for t in tree.values() if not t.is_cuda]
    assert host and all(t.is_pinned() for t in host)
    assert offload.pinned_bytes(*trees) >= sum(t.numel() * t.element_size() for t in host)
    assert prog.transfer_bytes()["h2d"] > 0 and prog.transfer_bytes()["d2h"] > 0


def test_offload_dots_grads_equal_nothing_saveable_bitwise(cuda):
    cfg = tcfg.MODEL_CONFIGS["gpt-tiny"].with_(attention_impl="flash")
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = ttfm.init_params(cfg, gen, "cuda")
    tokens = torch.randint(0, cfg.vocab_size, (2, 128), generator=gen, device="cuda")

    stash = offload.host_stash("cuda")
    stash.release()
    held = []

    def grads(policy):
        for p in params.values():
            p.grad = None
        logits = ttfm.forward(params, tokens, cfg, compute_dtype=torch.bfloat16, remat=True,
                              remat_policy=policy)
        held.append((stash.in_use, stash.nbytes))
        ttrain.lm_loss(logits, tokens).backward()
        return {k: p.grad.clone() for k, p in params.items()}

    want, got = grads("nothing_saveable"), grads("offload_dots")
    for k in want:
        assert torch.equal(got[k], want[k]), k
    # The products sit in page-locked blocks of their own size (each a
    # multiple of 256 bytes here), free again once the graph is gone.
    assert held[0] == (0, 0) and held[1][0] == held[1][1] > 0
    gc.collect()
    assert stash.in_use == 0
    again = grads("offload_dots")
    assert held[2] == held[1]  # the blocks served the second forward
    assert all(torch.equal(again[k], want[k]) for k in want)
    stash.release()
    assert stash.nbytes == 0
