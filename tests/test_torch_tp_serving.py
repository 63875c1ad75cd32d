"""Port parity: ``ContinuousBatcher(mesh=...)`` at model=2, two ``gloo``
ranks on the CPU (``tests/torch_mesh_worker.py``), fed on rank 0 only,
against the JAX package's single-device batcher and the port's own.

Each rank holds its ``model`` blocks of the weights (whole heads, MLP
columns, experts, vocabulary rows) and its kv heads of the pool. Cases, in
fp32: qwen-tiny (two kv heads, one a rank) with a prefix cache and a
sampled request beside the greedy ones; gemma-tiny (one kv head, the pool
whole on each rank, the tied head vocabulary-parallel); moe-tiny (two
experts a rank); qwen-tiny with the int8 pool. Checks: every greedy stream
is token-identical to JAX's batcher on the same submissions (and its
prefix-cache hits equal JAX's); every stream, sampled included, equals the
port's one-device batcher's; rank 1's streams equal rank 0's; the int8
pool's first-token logits are within 2 % of the largest fp32-pool logit
(JAX's int8-cache bound, tests/test_generate.py); a draft raises
``SpecGeometryError`` of kind ``draft_mesh_sharded`` and a mesh with
data=2 ``NotImplementedError``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tpu_engine import serving as jsrv  # noqa: E402
from tpu_engine.models import transformer as jtfm  # noqa: E402
from tpu_engine_torch import serving as tsrv  # noqa: E402
from tpu_engine_torch.models import config as tcfg  # noqa: E402
from tpu_engine_torch.models import convert  # noqa: E402
from test_torch_mesh_train import _unflatten  # noqa: E402
from test_torch_serving import _drive  # noqa: E402
from torch_mesh_worker import spawn  # noqa: E402

WORLD = 2
INT8_SHARE = 0.02
_BATCHER = dict(max_slots=2, max_len=96, prefill_pad_to=8, prefill_chunk=16, chunk_steps=2)
# (case, model, batcher fields beyond _BATCHER)
CASES = [
    ("qwen", "qwen-tiny", dict(prefix_cache_tokens=64)),
    ("gemma", "gemma-tiny", {}),
    ("moe", "moe-tiny", {}),
    ("qwen_int8", "qwen-tiny", dict(kv_quant=True)),
]
SAMPLED = 2  # the request of the plan drawn at temperature 0.8


def _weights(model: str) -> dict:
    """JAX's init (the router drawn wider: clear routing margins,
    tests/test_torch_moe.py), flattened to the port's keys."""
    tree = jax.tree.map(np.asarray, jtfm.init_params(jax.random.PRNGKey(7),
                                                     jtfm.MODEL_CONFIGS[model]))
    flat = convert._flatten(tree)
    if "layers.router.kernel" in flat:
        flat["layers.router.kernel"] = flat["layers.router.kernel"] * 5.0
    return flat


def _plan() -> list:
    """Five requests on two slots, staggered: three share a 24-token
    prefix (a prefix-cache hit), one is sampled."""
    rng = np.random.default_rng(3)
    system = rng.integers(1, 512, 24).tolist()
    tails = [rng.integers(1, 512, n).tolist() for n in (5, 9, 3, 12, 7)]
    prompts = [system + tails[0], tails[1], system + tails[2], system + tails[3], tails[4]]
    return [[0, prompts[0], 6, 0.0], [0, prompts[1], 8, 0.0], [1, prompts[2], 7, 0.8],
            [3, prompts[3], 5, 0.0], [4, prompts[4], 6, 0.0]]


def _greedy_plan(plan: list) -> list:
    return [[at, p, m, 0.0] for at, p, m, _ in plan]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp_serving")
    plan, cases, flats = _plan(), [], {}
    for name, model, extra in CASES:
        init = tmp / f"{model}.npz"
        if model not in flats:
            flats[model] = _weights(model)
            np.savez(init, **flats[model])
        cases.append({"name": name, "kind": "serve", "mesh": {"model": 2}, "model": model,
                      "init": str(init), "plan": plan, "batcher": {**_BATCHER, **extra}})
    cases.append({"name": "refusals", "kind": "serve", "mesh": {"model": 2},
                  "model": "qwen-tiny", "init": str(tmp / "qwen-tiny.npz"), "refusals": True})

    def references():  # JAX's and the one-device port's batchers, while the ranks run
        out = {}
        for name, model, extra in CASES:
            jp = jax.tree.map(jnp.asarray, _unflatten(flats[model]))
            jax_srv = jsrv.ContinuousBatcher(jp, jtfm.MODEL_CONFIGS[model],
                                             compute_dtype=jnp.float32, **_BATCHER, **extra)
            greedy = _drive(jax_srv, _greedy_plan(plan))
            port = tsrv.ContinuousBatcher({k: torch.tensor(v) for k, v in flats[model].items()},
                                          tcfg.MODEL_CONFIGS[model], compute_dtype=torch.float32,
                                          device="cpu", **_BATCHER, **extra)
            out[name] = {"jax": greedy, "port": _drive(port, plan),
                         "jax_hits": jax_srv.stats().get("prefix_cache", {}).get("hits")}
        return out

    got, refs = spawn({"cases": cases}, WORLD, tmp, during=references)
    return got, refs, plan


def _streams(out: dict, n: int) -> list:
    return [out[f"tokens:{i}"].tolist() for i in range(n)]


@pytest.mark.parametrize("case", [c[0] for c in CASES])
def test_greedy_streams_token_identical_to_jax(runs, case):
    """Every greedy request's stream on each rank equals JAX's
    single-device batcher's on the same submissions."""
    got, refs, plan = runs
    for r in range(WORLD):
        streams = _streams(got[(case, r)], len(plan))
        assert all(bool(got[(case, r)][f"status_done:{i}"]) for i in range(len(plan)))
        for i, want in enumerate(refs[case]["jax"]):
            if i != SAMPLED:
                assert streams[i] == want, (case, r, i)


@pytest.mark.parametrize("case", [c[0] for c in CASES])
def test_ranks_equal_and_equal_one_device_port(runs, case):
    """Rank 1's streams equal rank 0's, the sampled one included, and
    both equal the port's one-device batcher's."""
    got, refs, plan = runs
    s0, s1 = (_streams(got[(case, r)], len(plan)) for r in range(WORLD))
    assert s1 == s0
    assert s0 == refs[case]["port"]


def test_pool_holds_the_ranks_kv_heads(runs):
    """qwen-tiny's two kv heads split (one a rank); gemma-tiny's one kv
    head does not, and its pool is whole on each rank, as JAX's."""
    got, _, _ = runs
    for r in range(WORLD):
        assert int(got[("qwen", r)]["kv_heads"]) == 1
        assert int(got[("qwen_int8", r)]["kv_heads"]) == 1
        assert int(got[("gemma", r)]["kv_heads"]) == 1 == tcfg.MODEL_CONFIGS["gemma-tiny"].n_kv_heads


def test_prefix_cache_hits_on_the_mesh(runs):
    """The requests sharing a prefix hit the cache on every rank, as often
    as on JAX's batcher."""
    got, refs, _ = runs
    for r in range(WORLD):
        assert int(got[("qwen", r)]["hits"]) >= 1
        assert int(got[("qwen", r)]["hits"]) == refs["qwen"]["jax_hits"]


def test_int8_pool_within_two_percent(runs):
    """The int8 pool's first-token logits against the fp32 pool's: within
    2 % of the largest logit (JAX's bound for its int8 cache)."""
    got, _, plan = runs
    for r in range(WORLD):
        for i in range(len(plan)):
            full, q = got[("qwen", r)][f"first:{i}"], got[("qwen_int8", r)][f"first:{i}"]
            assert np.abs(q - full).max() < INT8_SHARE * np.abs(full).max(), i


def test_mesh_refusals(runs):
    """A draft on the mesh raises JAX's ``draft_mesh_sharded``; a mesh
    with data=2 raises ``NotImplementedError`` naming what is missing."""
    got, _, _ = runs
    for r in range(WORLD):
        assert str(got[("refusals", r)]["draft_kind"]) == "draft_mesh_sharded"
        assert "serving fleet" in str(got[("refusals", r)]["data2"])
