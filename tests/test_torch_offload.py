"""Port parity: where the training state lives (``tpu_engine_torch.train``'s
``optimizer_offload`` and ``param_offload`` "host", ``param_dtype="bf16"``
and the ``sliding_window`` override) against JAX's train program on a
one-device mesh, on the CPU; the offloaded programs against the port's own
in-memory program, bitwise; every combination JAX refuses, with its
message.

On the CPU the "host" is the device: the update walk still copies each unit
in and out, and the masters stream a layer at a time with their gradients
summed in separate buffers, so a dropped or misplaced copy shows here."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tpu_engine import train as jtrain  # noqa: E402
from tpu_engine.mesh_runtime import MeshConfig, MeshRuntime  # noqa: E402
from tpu_engine.sharding import TPUTrainConfig  # noqa: E402
from tpu_engine_torch import offload  # noqa: E402
from tpu_engine_torch import train as ttrain  # noqa: E402
from tpu_engine_torch.models import config as tcfg  # noqa: E402
from tpu_engine_torch.models import convert  # noqa: E402

_COMMON = dict(
    model_name="gpt-tiny", micro_batch_size=2, gradient_accumulation_steps=2,
    seq_len=32, precision="fp32", attention_impl="xla", learning_rate=1e-3,
    min_lr=1e-4, warmup_steps=2, total_steps=8, weight_decay=0.1,
    activation_checkpointing=True,
)
_STEPS = 3


def _batches(accum=2):
    rng = np.random.default_rng(0)
    return [rng.integers(0, 512, (accum, 2, 32)).astype(np.int32) for _ in range(_STEPS)]


def _run_jax(kw):
    cfg = TPUTrainConfig(mesh=MeshConfig(data=1), **kw)
    prog = jtrain.build_train_program(cfg, runtime=MeshRuntime(cfg.mesh,
                                                               devices=jax.devices()[:1]))
    state = prog.init(jax.random.PRNGKey(0))
    init = jax.tree.map(lambda a: np.asarray(a, np.float32), state["params"])
    losses = []
    for b in _batches(kw["gradient_accumulation_steps"]):
        state, m = prog.step(state, jax.device_put(jnp.asarray(b), prog.batch_sharding))
        losses.append(float(m["loss"]))
    return init, losses, jax.tree.map(lambda a: np.asarray(a, np.float32), state["params"]), prog


def _run_port(kw, init=None, model_cfg=None):
    prog = ttrain.build_train_program(ttrain.TrainConfig(**kw), model_cfg=model_cfg,
                                      device="cpu")
    params = None if init is None else convert.params_from_jax(init, prog.model_config,
                                                               device="cpu")
    state = prog.init(params=params)
    losses = []
    for b in _batches(kw["gradient_accumulation_steps"]):
        state, m = prog.step(state, torch.tensor(b, dtype=torch.long))
        losses.append(m["loss"])
    return torch.stack(losses), state, prog


# JAX's references, once per module: its own host placements (their numbers
# are its in-memory program's), bf16 masters and the window override.
_JAX_RUNS = {
    "optimizer_host": dict(optimizer_offload="host"),
    "param_host": dict(param_offload="host"),
    "bf16_masters": dict(param_dtype="bf16"),
    "window": dict(sliding_window=8),
}


@pytest.fixture(scope="module")
def jax_runs():
    return {name: _run_jax({**_COMMON, **extra}) for name, extra in _JAX_RUNS.items()}


def _leaves(tree):
    return {".".join(p.key for p in path): a
            for path, a in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.mark.parametrize("name,extra", [
    ("optimizer_host", dict(optimizer_offload="host")),
    ("param_host", dict(param_offload="host")),
    ("param_host", dict(optimizer_offload="host", param_offload="host")),
    ("window", dict(sliding_window=8)),
], ids=["optimizer_host", "param_host", "both_host", "window"])
def test_placements_match_jax(jax_runs, name, extra):
    """Three AdamW steps (fp32, accumulation 2) against JAX's program in the
    same placement: losses and every final weight within the AdamW parity
    bound of tests/test_torch_train.py (1e-6)."""
    init, jl, jp, jprog = jax_runs[name]
    if name == "window":
        assert jprog.model_config.sliding_window == 8
    tl, state, prog = _run_port({**_COMMON, **extra}, init)
    if name == "window":
        assert prog.model_config.sliding_window == 8
    np.testing.assert_allclose(tl.numpy(), jl, rtol=1e-6)
    got = convert._flatten(convert.params_to_numpy(state["params"]))
    for k, a in _leaves(jp).items():
        np.testing.assert_allclose(got[k], a, atol=1e-6, rtol=0, err_msg=k)


def test_bf16_masters_match_jax(jax_runs):
    """bf16 masters, fp32 compute, accumulation 2. Both packages follow
    optax's dtype order: each microbatch's gradient in the masters' bf16,
    summed over the microbatches in fp32; clipped in fp32; both moments
    held and updated in fp32 (optax's update of bf16 zeros by an fp32
    gradient is fp32); wd·p in bf16; p + (-lr·u) in fp32 rounded once to
    bf16. So they differ only where the fp32 arithmetic of the two
    backward passes (about 1e-7 of a value apart) tips one of the bf16
    roundings, that of a microbatch's gradient or that of the new weight:
    a weight then lands one bf16 ulp away, and a step later may move one
    ulp more. Bound: losses within JAX's AdamW bound (rtol 1e-6); each
    weight within one ulp a step that updates (2 ulps of the largest of its
    initial and two final values; step 0's learning rate is 0), at most
    1e-3 of the weights off at all (1.5e-4 measured, the worst 2 ulps)."""
    init, jl, jp, _ = jax_runs["bf16_masters"]
    tl, state, _ = _run_port({**_COMMON, **_JAX_RUNS["bf16_masters"]}, init)
    assert all(p.dtype == torch.bfloat16 for p in state["params"].values())
    assert all(t.dtype == torch.float32 for n, tree in state["opt_state"].items()
               if n != "count" for t in tree.values())
    np.testing.assert_allclose(tl.numpy(), jl, rtol=1e-6)
    got = convert._flatten(convert.params_to_numpy(state["params"]))
    off = total = 0
    start = _leaves(init)
    for k, a in _leaves(jp).items():
        big = np.maximum(np.maximum(np.abs(a), np.abs(got[k])), np.abs(start[k])) + 1e-30
        ulp = np.exp2(np.floor(np.log2(big)) - 7)
        assert np.all(np.abs(got[k] - a) <= 2 * ulp), k
        off += int(np.sum(got[k] != a))
        total += a.size
    assert off <= 1e-3 * total, (off, total)


_HOST = [dict(optimizer_offload="host"), dict(param_offload="host"),
         dict(optimizer_offload="host", param_offload="host")]


@pytest.mark.parametrize("extra", [
    *_HOST,
    dict(optimizer="adafactor", optimizer_offload="host", param_offload="host"),
    dict(optimizer="lion", optimizer_offload="host", param_offload="host"),
    dict(param_dtype="bf16", precision="bf16", optimizer_offload="host", param_offload="host"),
    dict(param_dtype="bf16", optimizer_offload="host", param_offload="host"),
    dict(moment_dtype="bf16", optimizer_offload="host", param_offload="host",
         remat_policy="save_attn_out"),
], ids=["optimizer", "params", "both", "adafactor", "lion", "bf16_masters",
        "bf16_masters_fp32_compute", "bf16_mu_named"])
def test_host_placements_equal_in_memory_bitwise(extra):
    """The offloaded program is the in-memory one with its tensors moved:
    losses, gradient norms and final weights equal bitwise, and so does
    the optimizer state."""
    base = {**_COMMON, **{k: v for k, v in extra.items()
                          if k not in ("optimizer_offload", "param_offload")}}
    want_losses, want, _ = _run_port(base)
    got_losses, got, prog = _run_port({**_COMMON, **extra})
    assert torch.equal(got_losses, want_losses)
    for k, p in want["params"].items():
        assert torch.equal(got["params"][k], p), k
    for name, tree in want["opt_state"].items():
        if name != "count":
            for k, t in tree.items():
                assert torch.equal(got["opt_state"][name][k], t), (name, k)
    moved = prog.transfer_bytes()
    assert moved["h2d"] > 0 and moved["d2h"] > 0


def test_host_placement_state_lives_in_one_unpinned_arena_on_the_cpu():
    """Each offloaded tree is one host buffer (no pinning without CUDA, and
    pinning raises there); the param placement streams every layer once in
    the forward and once in the recompute, and the update copies every
    master in and out once."""
    kw = {**_COMMON, "optimizer_offload": "host", "param_offload": "host"}
    prog = ttrain.build_train_program(ttrain.TrainConfig(**kw), device="cpu")
    state = prog.init()
    arenas = {id(t._host_arena) for t in state["params"].values()}
    assert len(arenas) == 1 and offload.pinned_bytes(state["params"]) == 0
    assert len({id(t._host_arena) for t in state["opt_state"]["mu"].values()}) == 1
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="needs CUDA"):
            offload.HostArena({"w": torch.zeros(4)}, pin=True)
    batch = prog.synthetic_batch(0)
    prog.step(state, batch)
    n_bytes = sum(p.numel() * p.element_size() for p in state["params"].values())
    layers = sum(p.numel() * p.element_size() for k, p in state["params"].items()
                 if k.startswith("layers."))
    accum = kw["gradient_accumulation_steps"]
    moved = prog.transfer_bytes()
    # forward + recompute of each layer, the non-layer leaves once, every
    # microbatch; the update reads masters and both moments, writes them back.
    assert moved["h2d"] == accum * (2 * layers + (n_bytes - layers)) + 3 * n_bytes
    assert moved["d2h"] == 3 * n_bytes


def test_grad_sums_are_fp32_sums_of_the_microbatches():
    """JAX's sum (fp32 zeros plus each microbatch's gradient): a handed-over
    leaf gradient is kept as it is until a second arrives, then converted
    and added in fp32 (1 + 2^-9 in bf16 would round back to 1); a stacked
    leaf's layers are copied first, added after, and a layer or a leaf no
    gradient reached is zero."""
    sums = offload.GradSums("cpu")
    like = {"w": torch.zeros(2), "layers.x": torch.zeros(3, 2), "unused": torch.zeros(4)}
    sums.begin(like)
    first = torch.tensor([1.0, 3.0], dtype=torch.bfloat16)
    sums.take("w", first)
    assert sums.sums["w"] is first
    sums.take("w", torch.tensor([2.0 ** -9, 1.0], dtype=torch.bfloat16))
    for i, g in ((0, [1.0, 2.0]), (2, [5.0, 6.0]), (0, [0.5, 0.25])):
        sums.add("layers.x", torch.tensor(g, dtype=torch.bfloat16), i)
    sums.sums["layers.x"][1].fill_(7.0)  # an unwritten layer holds garbage until finish
    got = sums.finish()
    assert all(g.dtype == torch.float32 for g in got.values())
    assert torch.equal(got["w"], torch.tensor([1.0 + 2.0 ** -9, 4.0]))
    assert torch.equal(got["layers.x"], torch.tensor([[1.5, 2.25], [0.0, 0.0], [5.0, 6.0]]))
    assert torch.equal(got["unused"], torch.zeros(4))


def test_host_stash_reuses_exact_blocks_and_releases_them():
    """``offload_dots``' cache: a copy in a block of the tensor's size (256-byte
    aligned), back as a copy; a dropped entry returns its block, which a
    later tensor of the same size takes; release frees the free blocks."""
    stash = offload.HostStash("cpu")
    a = torch.arange(64.0).reshape(4, 16)
    ea, eb = stash.put(a), stash.put(torch.ones(8, dtype=torch.bfloat16))
    assert (stash.in_use, stash.nbytes) == (256 + 16, 256 + 256)
    a.add_(1.0)
    back = stash.get(ea)
    assert torch.equal(back, torch.arange(64.0).reshape(4, 16))
    del ea, eb
    assert stash.in_use == 0
    ec = stash.put(torch.zeros(16, 4))
    assert stash.nbytes == 512 and stash.in_use == 256
    back.zero_()  # what get returned is not the block
    assert torch.equal(stash.get(ec), torch.zeros(16, 4))
    del ec
    stash.release()
    assert stash.nbytes == 0 and not any(stash.free.values())


def test_update_units_cut_large_leaves_into_whole_rows(monkeypatch):
    monkeypatch.setattr(offload, "UNIT_ELEMS", 1000)
    params = {"layers.w": torch.zeros(5, 10, 30), "small": torch.zeros(7), "big": torch.zeros(40, 30)}
    units = offload.update_units(params, split=True)
    assert units[:3] == [("layers.w", slice(0, 3)), ("layers.w", slice(3, 5)), ("small", slice(None))]
    assert [u for u in units if u[0] == "big"] == [("big", slice(0, 33)), ("big", slice(33, 40))]
    assert offload.update_units(params, split=False) == [(k, slice(None)) for k in params]


def test_bf16_masters_update_in_optaxs_dtype_order():
    """One AdamW update of a bf16 master against optax's dtype order written
    out: the gradient in fp32, the moments in fp32, wd·p a bf16 product
    (wd rounded to bf16), p + (-lr·u) in fp32 rounded once to bf16. The
    same update with -lr·u rounded to bf16 before the sum (twice rounded)
    lands elsewhere on some weights, so the check can tell them apart."""
    gen = torch.Generator().manual_seed(0)
    p = (torch.randn(4096, generator=gen) * 0.02).to(torch.bfloat16)
    g = (torch.randn(4096, generator=gen) * 1e-3).to(torch.bfloat16)
    lr, wd, b1, b2 = 3e-3, 0.1, 0.9, 0.95
    tx = ttrain.AdamW(weight_decay=wd, grad_clip_norm=1e9, decay_all_params=True, b1=b1, b2=b2)
    params = {"w": p.clone()}
    state = tx.init(params)
    tx.update(params, {"w": g.clone()}, state, lr)
    g32 = g.float()
    mu, nu = (1 - b1) * g32, (1 - b2) * g32 * g32
    u = (mu / (1 - b1)) / ((nu / (1 - b2)).sqrt() + 1e-8)
    u = u + (p * torch.tensor(wd, dtype=torch.bfloat16)).float()
    want = (p.float() + (-lr * u)).to(torch.bfloat16)
    twice = (p.float() + (-lr * u).to(torch.bfloat16).float()).to(torch.bfloat16)
    assert torch.equal(params["w"], want)
    assert not torch.equal(twice, want)
    assert torch.equal(state["mu"]["w"], mu) and torch.equal(state["nu"]["w"], nu)


def _jax_error(kw, build=False):
    with pytest.raises(ValueError) as err:
        cfg = TPUTrainConfig(mesh=MeshConfig(data=1), **kw)
        if build:
            jtrain.build_train_program(cfg, runtime=MeshRuntime(cfg.mesh,
                                                                devices=jax.devices()[:1]))
    return str(err.value)


@pytest.mark.parametrize("kw,build", [
    (dict(optimizer_offload="disk"), False),
    (dict(optimizer_spill_dir="/tmp/spill"), False),
    (dict(disk_update_overlap=True), False),
    (dict(param_offload="disk"), False),
    (dict(optimizer_offload="disk", optimizer_spill_dir="/tmp/s", optimizer="adafactor"), False),
    (dict(optimizer_offload="disk", optimizer_spill_dir="/tmp/s", optimizer="lion"), False),
    (dict(optimizer_offload="disk", optimizer_spill_dir="/tmp/s", moment_dtype="bf16"), False),
    (dict(optimizer_offload="disk", optimizer_spill_dir="/tmp/s", param_offload="host"), False),
    (dict(optimizer_offload="disk", optimizer_spill_dir="/tmp/s", lora_rank=4), False),
    (dict(param_offload="host", lora_rank=4), True),
], ids=["disk_no_dir", "dir_no_disk", "overlap_no_disk", "param_disk", "disk_adafactor",
        "disk_lion", "disk_moment_dtype", "disk_param_offload", "disk_lora", "param_lora"])
def test_refusals_carry_jaxs_message(kw, build):
    kw = {"model_name": "gpt-tiny", "seq_len": 32, **kw}
    want = _jax_error(kw, build)
    with pytest.raises(ValueError) as got:
        ttrain.build_train_program(ttrain.TrainConfig(**kw), device="cpu")
    assert str(got.value) in want, (str(got.value), want)


def test_config_values_and_window_resolution():
    for bad in (dict(optimizer_offload="nvme"), dict(param_offload="gpu"),
                dict(sliding_window=-1), dict(param_dtype="fp16")):
        with pytest.raises(ValueError):
            ttrain.TrainConfig(**bad)
    windowed = tcfg.MODEL_CONFIGS["gpt-tiny"].with_(sliding_window=16)
    for override, want in ((None, 16), (0, 0), (8, 8)):
        prog = ttrain.build_train_program(
            ttrain.TrainConfig(model_name="gpt-tiny", seq_len=32, sliding_window=override),
            model_cfg=windowed, device="cpu")
        assert prog.model_config.sliding_window == want
    # The override reaches the ring refusal, as in JAX.
    with pytest.raises(ValueError, match="sliding_window=8 is not supported"):
        ttrain.build_train_program(ttrain.TrainConfig(model_name="gpt-tiny", seq_len=32,
                                                      sequence=2, sliding_window=8),
                                   device="cpu")
