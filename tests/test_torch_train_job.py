"""Port parity of the slice as a whole: train gpt-tiny from a token file,
checkpoint it, restore it into a fresh program and keep training.

One device, fp32; the port's attention is ``"flash"`` on its plain path
(a CPU tensor), JAX's ``"xla"``. Both packages write the same token file,
read it through their ``make_data_fn`` (the same shuffle), take steps 1–2,
save step 2 with their ``TrainCheckpointManager``, restore it into a fresh
program and take step 3. The losses and final weights are within the
AdamW bound of tests/test_torch_train.py (1e-6 on the weights at lr 1e-3),
and the port's restored run is bitwise its uninterrupted three steps."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402

from tpu_engine import checkpoint as jck  # noqa: E402
from tpu_engine import data as jdata  # noqa: E402
from tpu_engine import train as jtrain  # noqa: E402
from tpu_engine.mesh_runtime import MeshConfig, MeshRuntime  # noqa: E402
from tpu_engine.sharding import TPUTrainConfig  # noqa: E402
from tpu_engine_torch import checkpoint as tck  # noqa: E402
from tpu_engine_torch import data as tdata  # noqa: E402
from tpu_engine_torch import train as ttrain  # noqa: E402
from tpu_engine_torch.models import convert  # noqa: E402

_KW = dict(model_name="gpt-tiny", micro_batch_size=2, gradient_accumulation_steps=2, seq_len=32,
           precision="fp32", learning_rate=1e-3, min_lr=1e-4, warmup_steps=1, total_steps=8,
           weight_decay=0.1)


def _token_file(path) -> str:
    toks = np.random.default_rng(0).integers(0, 512, 40 * 32 + 3).astype(np.uint16)
    jdata.write_token_file(toks, str(path))
    return str(path)


def _jax_job(tmp_path, tokens: str):
    """JAX's flow: steps 1–2 from its data_fn, a save, a fresh program
    restored, step 3. Returns (initial params, losses, final params)."""
    def program():
        cfg = TPUTrainConfig(mesh=MeshConfig(data=1), attention_impl="xla", **_KW)
        return jtrain.build_train_program(cfg, runtime=MeshRuntime(cfg.mesh,
                                                                   devices=jax.devices()[:1]))

    prog = program()
    state = prog.init(jax.random.PRNGKey(0))
    init = jax.tree.map(np.asarray, state["params"])
    data_fn = jdata.make_data_fn(prog, jdata.TokenFileDataset(tokens, 32, prefer_native=False),
                                 seed=3)
    losses = []
    for step in range(2):
        state, m = prog.step(state, data_fn(step))
        losses.append(float(m["loss"]))
    mgr = jck.TrainCheckpointManager(str(tmp_path / "jax_ck"), async_save=False)
    assert mgr.save(2, state, wait=True)
    prog2 = program()
    shape = jax.eval_shape(lambda: prog2.init(jax.random.PRNGKey(0)))
    step, state = mgr.restore(jck.abstract_state_like(prog2.state_shardings, shape))
    assert step == 2
    state, m = prog2.step(state, data_fn(2))
    losses.append(float(m["loss"]))
    mgr.close()
    return init, losses, jax.tree.map(np.asarray, state["params"])


def _port_job(tmp_path, tokens: str, init: dict, restart: bool):
    cfg = ttrain.TrainConfig(attention_impl="flash", **_KW)

    def program():
        return ttrain.build_train_program(cfg, device="cpu")

    prog = program()
    assert prog.model_config.attention_impl == "flash"
    state = prog.init(params=convert.params_from_jax(init, prog.model_config, device="cpu"))
    data_fn = tdata.make_data_fn(prog, tdata.TokenFileDataset(tokens, 32), seed=3)
    assert data_fn.reader == "native"
    losses = []
    for step in range(2):
        state, m = prog.step(state, data_fn(step))
        losses.append(float(m["loss"]))
    if restart:
        mgr = tck.TrainCheckpointManager(str(tmp_path / "port_ck"), program=prog)
        assert mgr.save(2, state)  # asynchronous
        mgr.wait_until_finished()
        prog = program()
        step, state = tck.TrainCheckpointManager(str(tmp_path / "port_ck"), program=prog).restore(
            tck.abstract_state_like(prog))
        assert step == 2 and state["step"] == 2
    state, m = prog.step(state, data_fn(2))
    losses.append(float(m["loss"]))
    data_fn.close()
    return losses, {k: v.detach().clone() for k, v in state["params"].items()}


def test_train_save_restore_flow_matches_jax(tmp_path):
    tokens = _token_file(tmp_path / "tokens.bin")
    init, jl, jp = _jax_job(tmp_path, tokens)
    tl, tp = _port_job(tmp_path, tokens, init, restart=True)
    ul, up = _port_job(tmp_path, tokens, init, restart=False)
    assert tl == ul  # bitwise the uninterrupted run
    assert all(torch.equal(tp[k], up[k]) for k in up)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    want = convert._flatten(jp)
    for k, v in tp.items():
        np.testing.assert_allclose(v.numpy(), want[k], atol=1e-6, err_msg=k)
