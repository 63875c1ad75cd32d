"""Port parity: dense-dispatch MoE over the ``sequence`` axis
(``tpu_engine_torch/models/transformer.py``, ``_moe_mlp``) against JAX's
single-device program at the same global batch, on four ``gloo`` ranks
(``tests/torch_mesh_worker.py``): moe-tiny with the ring across
(fsdp=2, sequence=2) and (data=2, sequence=2).

JAX's program routes on the global sequence: an expert's capacity is the
whole row's (``expert_capacity(S)``), and the greedy assignment places all
first choices along the whole row before any second choice. A sequence
rank holds a block of each row, so its token's buffer position adds the
same choice's counts of the lower sequence ranks (one all-gather of
[B, E] counts a choice) to the whole row's counts of the earlier choices.
The capacity factor is cut to 0.5 in one case so that tokens past
capacity drop on both ranks of a row. Routers at 5× their init (clear
margins, as ``tests/test_torch_mesh_train.py``).

Bounds: ``tests/test_torch_mesh_train.py``'s (losses rtol 1e-6, gradient
norms 1e-5, the held-out loss 1e-6 and every final weight 1e-6)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from test_torch_mesh_train import _KW, ROWS, _batches, _check, _init, _unflatten  # noqa: E402
from tpu_engine import train as jtrain  # noqa: E402
from tpu_engine.mesh_runtime import MeshConfig, MeshRuntime  # noqa: E402
from tpu_engine.models import transformer as jtfm  # noqa: E402
from tpu_engine.sharding import TPUTrainConfig  # noqa: E402
from torch_mesh_worker import spawn  # noqa: E402

WORLD = 4
# (case, mesh, model config fields)
CASES = [
    ("fsdp_seq", dict(fsdp=2, sequence=2), {}),
    ("data_seq_drops", dict(data=2, sequence=2), dict(capacity_factor=0.5)),
]


def _jax_run(flat: dict, batches: np.ndarray, model_cfg: dict):
    """JAX's single-device program with moe-tiny's fields changed:
    losses, norms, final flat weights, held-out loss of the first batch."""
    from tpu_engine_torch.models import convert

    jc = jtfm.MODEL_CONFIGS["moe-tiny"].with_(**model_cfg)
    cfg = TPUTrainConfig(model_name="moe-tiny", micro_batch_size=ROWS, moe_impl="dense",
                         mesh=MeshConfig(data=1), **_KW)
    prog = jtrain.build_train_program(cfg, model_cfg=jc, runtime=MeshRuntime(
        cfg.mesh, devices=jax.devices()[:1]))
    state = prog.init(jax.random.PRNGKey(0))
    state["params"] = jax.device_put(jax.tree.map(jnp.asarray, _unflatten(flat)),
                                     jax.tree.map(lambda a: a.sharding, state["params"]))
    losses, norms = [], []
    for b in batches:
        state, m = prog.step(state, jax.device_put(jnp.asarray(b), prog.batch_sharding))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    held = float(prog.eval_step(state, jax.device_put(jnp.asarray(batches[0]),
                                                      prog.batch_sharding)))
    return (np.array(losses), np.array(norms),
            convert._flatten(jax.tree.map(np.asarray, state["params"])), held)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_moe_seq")
    batches = _batches()
    np.save(tmp / "batches.npy", batches)
    flat = _init("moe-tiny")
    np.savez(tmp / "init.npz", **flat)
    cases = []
    for name, mesh, mcfg in CASES:
        dp = mesh.get("data", 1) * mesh.get("fsdp", 1)
        cases.append(dict(name=name, kind="train", mesh=mesh, init=str(tmp / "init.npz"),
                          batches=str(tmp / "batches.npy"), model_cfg=mcfg,
                          cfg={**_KW, "model_name": "moe-tiny", "moe_impl": "dense",
                               "micro_batch_size": ROWS // dp}))

    def references():
        return {name: _jax_run(flat, batches, mcfg) for name, _, mcfg in CASES}

    got, refs = spawn({"cases": cases}, WORLD, tmp, during=references)
    return {name: ([got[(name, r)] for r in range(WORLD)], refs[name]) for name, _, _ in CASES}


@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_dense_moe_over_sequence_matches_jax(runs, name):
    """Dense dispatch with each row split over two sequence ranks: losses,
    norms, the held-out loss and every final weight (the router's and the
    experts' included) against JAX's single-device program."""
    _check(*runs[name])


def test_capacity_drops_tokens_in_the_cut_case():
    """At the cut capacity factor a row's experts hold fewer slots than its
    choices (E · C < top_k · S), so tokens drop whatever the routing, and
    the offsets across the sequence ranks decide which."""
    jc = jtfm.MODEL_CONFIGS["moe-tiny"].with_(**CASES[1][2])
    S = _KW["seq_len"]
    assert jc.n_experts * jc.expert_capacity(S) < jc.top_k * S
