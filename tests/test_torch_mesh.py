"""Port parity: the mesh layer of ``tpu_engine_torch`` (``mesh_runtime.py``,
``sharding.py``, ring and Ulysses attention across ranks) against the JAX
package, on the CPU.

Without processes: ``MeshConfig``'s shapes and errors, ``derive_elastic_mesh``,
the ZeRO specs of every leaf of the tiny models at stages 0–3, and the
refusals. With processes (``tests/torch_mesh_worker.py``, ``gloo``): a
two-process rendezvous through ``initialize_distributed`` from torchrun's
environment, and one spawn of four ranks holding ring attention across the
ranks (``distributed_rotation``) to the one-process ring and Ulysses to
plain attention, forward and gradients."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import socket  # noqa: E402

import jax  # noqa: E402

from tpu_engine import lora as jlora  # noqa: E402
from tpu_engine import mesh_runtime as jmr  # noqa: E402
from tpu_engine import sharding as jsh  # noqa: E402
from tpu_engine.models import transformer as jtfm  # noqa: E402
from tpu_engine_torch import mesh_runtime as tmr  # noqa: E402
from tpu_engine_torch import sharding as tsh  # noqa: E402
from tpu_engine_torch import train as ttrain  # noqa: E402
from tpu_engine_torch.models import config as tcfg  # noqa: E402
from tpu_engine_torch.models import convert  # noqa: E402
from tpu_engine_torch.ops import flash_attention as tfa  # noqa: E402
from tpu_engine_torch.parallel.ring_attention import ring_mha  # noqa: E402
from torch_mesh_worker import spawn  # noqa: E402

# The cases of tests/test_mesh_runtime.py, on 8 devices.
SHAPES = [dict(fsdp=8), dict(fsdp=4), dict(model=2, fsdp=2), dict(sequence=4), dict(pipe=4),
          dict(pipe=2, model=2), dict(data=8)]
MODELS = ["gpt-tiny", "gpt2-tiny", "qwen-tiny", "gemma-tiny", "moe-tiny"]


def _error(fn):
    """The message ``fn`` raises (ValueError, pydantic's included)."""
    with pytest.raises(ValueError) as info:
        fn()
    return str(info.value)


@pytest.mark.parametrize("kw", SHAPES, ids=[",".join(f"{k}={v}" for k, v in s.items())
                                            for s in SHAPES])
def test_resolved_shape_matches_jax(kw):
    assert tmr.MeshConfig(**kw).resolved_shape(8) == jmr.MeshConfig(**kw).resolved_shape(8)


@pytest.mark.parametrize("kw,n", [(dict(fsdp=3), 8), (dict(data=4, fsdp=4), 8),
                                  (dict(sequence=2), 1)])
def test_resolved_shape_errors_match_jax_word_for_word(kw, n):
    want = _error(lambda: jmr.MeshConfig(**kw).resolved_shape(n))
    assert _error(lambda: tmr.MeshConfig(**kw).resolved_shape(n)) == want


def test_mesh_config_validation_matches_jax():
    """JAX's model validator's messages; pydantic's bounds raise too."""
    for kw in (dict(data=0), dict(data=3, dcn_data=2)):
        want = _error(lambda: jmr.MeshConfig(**kw))
        assert _error(lambda: tmr.MeshConfig(**kw)) in want
    for kw in (dict(fsdp=0), dict(data=-2), dict(sequence=0)):
        _error(lambda: jmr.MeshConfig(**kw))
        _error(lambda: tmr.MeshConfig(**kw))
    assert tmr.MESH_AXES == jmr.MESH_AXES and tmr.BATCH_AXES == jmr.BATCH_AXES


@pytest.mark.parametrize("mesh,n,lo,hi", [
    (dict(fsdp=4), 8, 1, None), (dict(fsdp=4), 6, 2, None), (dict(fsdp=8, model=2), 8, 4, None),
    (dict(fsdp=2, sequence=2, dcn_data=2), 16, 4, 12), (dict(data=4), 3, 1, 2),
])
def test_derive_elastic_mesh_matches_jax(mesh, n, lo, hi):
    want = jmr.derive_elastic_mesh(jmr.MeshConfig(**mesh), n, lo, hi)
    got = tmr.derive_elastic_mesh(tmr.MeshConfig(**mesh), n, lo, hi)
    assert got == tmr.MeshConfig(**want.model_dump())
    with pytest.raises(ValueError) as j:
        jmr.derive_elastic_mesh(jmr.MeshConfig(**mesh), n, n + 1)
    with pytest.raises(ValueError) as t:
        tmr.derive_elastic_mesh(tmr.MeshConfig(**mesh), n, n + 1)
    assert str(t.value) == str(j.value)


def _flat_specs(tree) -> dict:
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    return {".".join(p.key for p in path): tuple(spec) for path, spec in flat}


@pytest.mark.parametrize("stage", [0, 1, 2, 3])
@pytest.mark.parametrize("name", MODELS)
def test_zero_specs_match_jax(name, stage):
    """Every leaf's logical axes, and its param, gradient and optimizer
    specs at ``stage`` (JAX's ``PartitionSpec`` as a tuple), and LoRA's."""
    jc = jtfm.MODEL_CONFIGS[name]
    jlog = jtfm.logical_axes(jc)
    tlog = tsh.logical_axes(tcfg.MODEL_CONFIGS[name])
    flat = jax.tree_util.tree_flatten_with_path(
        jlog, is_leaf=lambda x: isinstance(x, tuple))[0]
    assert tlog == {".".join(p.key for p in path): lg for path, lg in flat}
    assert set(tlog) == set(convert.param_keys(tcfg.MODEL_CONFIGS[name]))
    for jf, tf in ((jsh.param_pspecs, tsh.param_pspecs), (jsh.grad_pspecs, tsh.grad_pspecs),
                   (jsh.opt_state_pspecs, tsh.opt_state_pspecs)):
        assert tf(tlog, stage) == _flat_specs(jf(jlog, jsh.ShardingStage(stage)))
    if name != "moe-tiny":
        targets = ("q", "v")
        jl = jlora.lora_logical_axes(jlog, targets)
        tl = tsh.lora_logical_axes(tlog, targets)
        assert tsh.param_pspecs(tl, stage) == _flat_specs(
            jsh.param_pspecs(jl, jsh.ShardingStage(stage)))
    assert [int(s) for s in tsh.ShardingStage] == [int(s) for s in jsh.ShardingStage]


_KW = dict(model_name="gpt-tiny", micro_batch_size=1, seq_len=32)


def test_mesh_refusals():
    """JAX's ValueErrors first, then NotImplementedError for the axes and
    combinations the port does not run; a mesh of more ranks than the
    process has raises JAX's shape error (LoRA on ``model`` and ``pipe``
    meshes pass the refusals since they run)."""
    moe = tcfg.MODEL_CONFIGS["moe-tiny"]
    with pytest.raises(ValueError, match="expert parallelism"):
        ttrain.build_train_program(ttrain.TrainConfig(mesh=tmr.MeshConfig(model=2), **_KW),
                                   model_cfg=moe.with_(moe_impl="ragged"), device="cpu")
    for mesh, kw in ((dict(model=2), dict(lora_rank=4)), (dict(pipe=2), {})):
        want = _error(lambda: jmr.MeshConfig(**mesh).resolved_shape(1))
        assert _error(lambda: ttrain.build_train_program(
            ttrain.TrainConfig(mesh=tmr.MeshConfig(**mesh), **kw, **_KW), device="cpu")) == want
    with pytest.raises(ValueError, match="divisible by the pipe"):
        ttrain.build_train_program(ttrain.TrainConfig(mesh=tmr.MeshConfig(pipe=4), **_KW),
                                   device="cpu")
    with pytest.raises(NotImplementedError, match="grad_allreduce_dtype"):
        ttrain.TrainConfig(grad_allreduce_dtype="bf16", **_KW)
    with pytest.raises(ValueError, match="must be 'fp32' or match"):
        ttrain.TrainConfig(grad_allreduce_dtype="fp16", **_KW)
    assert ttrain.TrainConfig(grad_allreduce_dtype="fp32", **_KW).grad_allreduce_dtype == "fp32"
    with pytest.raises(ValueError, match="set one"):
        ttrain.TrainConfig(sequence=2, mesh=tmr.MeshConfig(sequence=2), **_KW)
    want = _error(lambda: jmr.MeshConfig(fsdp=2).resolved_shape(1))
    assert _error(lambda: ttrain.build_train_program(
        ttrain.TrainConfig(mesh=tmr.MeshConfig(fsdp=2), **_KW), device="cpu")) == want
    with pytest.raises(ValueError, match="sharding_stage"):
        ttrain.TrainConfig(sharding_stage=4, **_KW)
    cfg = ttrain.TrainConfig(sharding_stage=jsh.ShardingStage.GRADIENT_PARTITIONING, **_KW)
    assert cfg.sharding_stage == 2 and ttrain.TrainConfig(**_KW).sharding_stage == 3
    assert ttrain.TrainConfig(**_KW).mesh == tmr.MeshConfig()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_rendezvous_through_initialize_distributed(tmp_path):
    """Two processes join through ``initialize_distributed`` from torchrun's
    environment (``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``,
    ``WORLD_SIZE``; with none of it set it returns False), on ``gloo`` as
    ``device="cpu"`` asks; the default ``MeshConfig`` absorbs both ranks
    into ``data``; one all-reduce sums their values."""
    got = spawn({"master": _free_port(), "cases": [{"name": "join", "kind": "rendezvous"}]},
                2, tmp_path)
    for r in range(2):
        out = got[("join", r)]
        assert out["sizes"].tolist() == [2, 1, 1, 1, 1] and int(out["dp"]) == 2
        assert float(out["sum"]) == 3.0
        assert int(out["processes"]) == 2 and int(out["index"]) == r
        assert str(out["backend"]) == "gloo"


# (case, heads, kv heads, sequence length): the ring's dense body (a shard
# of 8 positions) and its flash body (64: the kernels' plain versions on
# the CPU), GQA in both; Ulysses with KV heads that split over the ranks
# and with too few (expanded first, as JAX does).
ATTN = [("ring_dense", "ring", 4, 2, 32), ("ring_flash", "ring", 4, 1, 256),
        ("ulysses", "ulysses", 4, 4, 64), ("ulysses_gqa", "ulysses", 4, 2, 64)]


@pytest.fixture(scope="module")
def attention_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_attention")
    cases, inputs = [], {}
    for i, (name, impl, H, KV, S) in enumerate(ATTN):
        rng = np.random.default_rng(i)
        data = {x: rng.standard_normal((2, S, h, 16)).astype(np.float32)
                for x, h in (("q", H), ("k", KV), ("v", KV), ("do", H))}
        np.savez(tmp / f"{name}.npz", **data)
        inputs[name] = data
        cases.append({"name": name, "kind": "attention", "impl": impl,
                      "mesh": {"sequence": 4}, "inputs": str(tmp / f"{name}.npz")})
    return spawn({"cases": cases}, 4, tmp), inputs


@pytest.mark.parametrize("name", [a[0] for a in ATTN])
def test_attention_across_ranks_equals_one_process(attention_runs, name):
    """Each rank's output shard and its q, k, v gradients, joined in rank
    order, equal the one-process reference on the whole sequence: the ring
    with every rank in one process (``ring_mha``, ``in_process_rotation``)
    for the ring, plain causal attention for Ulysses."""
    got, inputs = attention_runs
    data = inputs[name]
    impl = dict((a[0], a[1]) for a in ATTN)[name]
    q, k, v = (torch.tensor(data[x]).requires_grad_(True) for x in ("q", "k", "v"))
    o = ring_mha(q, k, v, sequence=4) if impl == "ring" else tfa.mha(q, k, v, causal=True)
    (o * torch.tensor(data["do"])).sum().backward()
    want = {"o": o.detach().numpy(), "dq": q.grad.numpy(), "dk": k.grad.numpy(),
            "dv": v.grad.numpy()}
    for x, w in want.items():
        joined = np.concatenate([got[(name, r)][x] for r in range(4)], axis=1)
        np.testing.assert_allclose(joined, w, atol=1e-5 * np.abs(w).max(), rtol=0, err_msg=x)
