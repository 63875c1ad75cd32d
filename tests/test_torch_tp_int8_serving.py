"""Port parity: weight-only int8 trees served on the mesh's ``model`` axis
(``ContinuousBatcher(mesh=...)`` with a ``QuantWeight`` tree, and
``quant.load_quantized(..., mesh=)``), two ``gloo`` ranks on the CPU,
against the JAX package's single-device batcher on the same int8 tree in
fp32.

At a quantized site the codes take the kernel's split and the scale the
same one, whole along the contracted dim (JAX's ``quantize_pspecs``): q/k/v,
gate/up, the experts and the head split codes and scales on their output
(or expert) dim; o and down split their codes on the input dim and keep
the scale whole, which multiplies each rank's partial product before the
sum over ``model``. Cases, in fp32: qwen-tiny's whole int8 tree, which the
batcher cuts; qwen-tiny's int8 snapshot written by JAX's
``save_quantized`` and read by each rank through ``load_quantized(...,
mesh=)`` (its block alone); moe-tiny's whole int8 tree (two experts a
rank). Checks: every greedy stream on each rank is token-identical to JAX's
batcher's; the ranks' streams are equal; the blocks a rank read from the
snapshot equal ``convert.model_block_np`` of JAX's int8 tree.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tpu_engine import quant as jquant  # noqa: E402
from tpu_engine import serving as jsrv  # noqa: E402
from tpu_engine.models import transformer as jtfm  # noqa: E402
from tpu_engine_torch.models import config as tcfg  # noqa: E402
from tpu_engine_torch.models import convert  # noqa: E402
from test_torch_mesh_train import _unflatten  # noqa: E402
from test_torch_serving import _drive  # noqa: E402
from test_torch_tp_serving import _BATCHER, _greedy_plan, _plan, _weights  # noqa: E402
from torch_mesh_worker import spawn  # noqa: E402

WORLD = 2
# (case, model, how the ranks get the int8 tree)
CASES = [("qwen_tree", "qwen-tiny", "tree"), ("qwen_snapshot", "qwen-tiny", "snapshot"),
         ("moe_tree", "moe-tiny", "tree")]


def _jax_int8(model: str):
    return jquant.quantize_params(jax.tree.map(jnp.asarray, _unflatten(_weights(model))))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp_int8_serving")
    plan = _greedy_plan(_plan())
    snapshot = str(tmp / "snapshot")
    jquant.save_quantized(_jax_int8("qwen-tiny"), snapshot, jtfm.MODEL_CONFIGS["qwen-tiny"])
    cases = []
    for name, model, how in CASES:
        init = tmp / f"{model}.npz"
        if not init.exists():
            np.savez(init, **_weights(model))
        cases.append({"name": name, "kind": "serve", "mesh": {"model": 2}, "model": model,
                      "init": str(init), "plan": plan, "batcher": _BATCHER, "quant": how,
                      "snapshot": snapshot})

    def references():  # JAX's batcher on the same int8 tree, while the ranks run
        out = {}
        for model in {m for _, m, _ in CASES}:
            srv = jsrv.ContinuousBatcher(_jax_int8(model), jtfm.MODEL_CONFIGS[model],
                                         compute_dtype=jnp.float32, **_BATCHER)
            out[model] = _drive(srv, plan)
        return out

    got, refs = spawn({"cases": cases}, WORLD, tmp, during=references)
    return got, refs, plan


def _streams(out: dict, n: int) -> list:
    return [out[f"tokens:{i}"].tolist() for i in range(n)]


@pytest.mark.parametrize("case", [c[0] for c in CASES])
def test_int8_greedy_streams_token_identical_to_jax(runs, case):
    """Every greedy stream on each rank equals JAX's single-device batcher
    on the same int8 tree; rank 1's equal rank 0's."""
    got, refs, plan = runs
    model = next(m for n, m, _ in CASES if n == case)
    s0 = _streams(got[(case, 0)], len(plan))
    for r in range(WORLD):
        assert all(bool(got[(case, r)][f"status_done:{i}"]) for i in range(len(plan)))
        assert _streams(got[(case, r)], len(plan)) == s0
    assert s0 == refs[model]


def test_snapshot_blocks_are_the_ranks(runs):
    """Each rank read its block of every leaf of JAX's snapshot: codes
    split with the kernel, a row-split site's scale (o, down) whole, a
    column-split site's (q, gate, the head) split with its codes."""
    got, _, _ = runs
    cfg = tcfg.MODEL_CONFIGS["qwen-tiny"]
    flat = convert._flatten(jax.tree.map(np.asarray, _jax_int8("qwen-tiny")))
    for r in range(WORLD):
        out = got[("qwen_snapshot", r)]
        want = convert.model_block_np(flat, cfg, WORLD, r)
        for k, v in want.items():
            if isinstance(v, tuple):
                np.testing.assert_array_equal(out[f"held:{k}.q"], v[0], err_msg=k)
                np.testing.assert_array_equal(out[f"held:{k}.scale"], v[1], err_msg=k)
            else:
                np.testing.assert_array_equal(out[f"held:{k}"], v, err_msg=k)
        whole = flat["layers.o.kernel"]
        assert out["held:layers.o.kernel.q"].shape[1] * WORLD == whole.q.shape[1]
        assert out["held:layers.o.kernel.scale"].shape == whole.scale.shape
        assert out["held:layers.q.kernel.scale"].shape[-1] * WORLD == \
            flat["layers.q.kernel"].scale.shape[-1]
