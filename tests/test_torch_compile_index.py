"""Port parity: the compile index (``tpu_engine_torch/compile_index.py``)
against JAX's copy through one script of calls — records warm and cold,
the EMA, eviction, ``invalidate``, the sidecar with ``attach_dir`` and a
``PrecompileWorker`` with a fake precompile function and an injected
``precompile-error`` — and the kernel build directory
(``tpu_engine_torch/compile_cache.py``): enable, re-point and the
no-device result, on a ``tmp_path`` directory. The keys' runtime half
differs by design (JAX's versions against torch's, CUDA's and the kernel
sources' hash), so the script keys by layout labels the two share."""

import time

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from tpu_engine import compile_index as jci  # noqa: E402
from tpu_engine import faults as jfaults  # noqa: E402
from tpu_engine.mesh_runtime import MeshConfig  # noqa: E402
from tpu_engine.sharding import TPUTrainConfig  # noqa: E402
from tpu_engine_torch import compile_cache as tcc  # noqa: E402
from tpu_engine_torch import compile_index as tci  # noqa: E402
from tpu_engine_torch import faults as tfaults  # noqa: E402
from tpu_engine_torch.mesh_runtime import MeshConfig as TMeshConfig  # noqa: E402
from tpu_engine_torch.ops import _flash_cuda  # noqa: E402
from tpu_engine_torch.train import TrainConfig  # noqa: E402


def _wait(pred, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.01)
    return pred()


def _script(mod, sidecar: str) -> list:
    """One sequence of index calls; what each returned, in order."""
    clock = iter(float(i) for i in range(1000))
    idx = mod.CompileCacheIndex(path=sidecar, max_entries=3, ema_alpha=0.3,
                                clock=lambda: next(clock))
    out = [idx.is_warm("a"), idx.expected_cold_s("a"), idx.expected_compile_s("a")]
    out.append(idx.record("a", 12.0, cache_hit=False, label="data2·s3", model="gpt-tiny"))
    out.append(idx.record("a", 20.0, cache_hit=False))
    out.append(idx.record("a", 0.4, cache_hit=True))
    out += [idx.is_warm("a"), idx.expected_cold_s("a"), idx.expected_compile_s("a"),
            idx.expected_cold_s("never"), idx.expected_compile_s("never")]
    for k in ("b", "c", "d"):  # the fourth evicts the least recently used
        idx.record(k, 3.0, cache_hit=False, label=k)
    idx.touch("b")
    out += [sorted(e["key"] for e in idx.entries()), idx.stats()]
    out.append(idx.invalidate("c"))
    out += [idx.is_warm("c"), idx.invalidate(), idx.entries()]
    idx.record("e", 5.0, cache_hit=False, label="e")
    reborn = mod.CompileCacheIndex(path=sidecar)
    out.append([(e["key"], e["warm"], e["cold_ema_s"]) for e in reborn.entries()])
    other = mod.CompileCacheIndex()
    other.record("f", 1.0, cache_hit=False)
    other.attach_dir(str(sidecar).rsplit("/", 1)[0])
    out.append(sorted(e["key"] for e in other.entries()))
    return [_plain(x) for x in out]


def _plain(x):
    """A result without its wall-clock fields."""
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()
                if k not in ("ts", "updated_at", "path", "sidecar_path")}
    if isinstance(x, list):
        return [_plain(v) for v in x]
    return x


def test_index_script_matches_jax(tmp_path):
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    want = _script(jci, str(tmp_path / "j" / jci.SIDECAR_NAME))
    got = _script(tci, str(tmp_path / "t" / tci.SIDECAR_NAME))
    assert got == want


@pytest.mark.parametrize("mesh,fields", [
    (dict(data=2, fsdp=4), dict(sharding_stage=3)),
    (dict(data=1, pipe=2), dict(pipeline_schedule="auto", gradient_accumulation_steps=4)),
    (dict(data=2, model=2), dict(quant_training="int8", sharding_stage=1)),
    (dict(data=4, fsdp=2, dcn_data=2), dict(comm_quant_weights=True, comm_quant_grads=True)),
    (dict(data=-1, fsdp=2), dict()),
])
def test_labels_and_digests_match_jax(mesh, fields):
    kw = dict(model_name="gpt-tiny", seq_len=64, micro_batch_size=2, **fields)
    jc = TPUTrainConfig(mesh=MeshConfig(**mesh), **kw)
    tc = TrainConfig(mesh=TMeshConfig(**mesh), **kw)
    for gang in ((None, 8, 16) if mesh["data"] == -1 else (None,)):
        assert tci.label_for_config(tc, gang=gang) == jci.label_for_config(jc, gang=gang)
    assert tci.label_for_config(tc, mesh={"data": 4, "model": 2}) == \
        jci.label_for_config(jc, mesh={"data": 4, "model": 2})
    assert tci.key_for_config(tc).split("|")[2] == jci.key_for_config(jc).split("|")[2]
    # The digest hashes JAX's fields; JAX's precision is an enum whose str
    # differs from the port's plain string, so the digests differ by design.
    assert tci.model_digest(tc) == tci.model_digest(TrainConfig(mesh=TMeshConfig(**mesh), **kw))
    assert tci.model_digest(tc) != tci.model_digest(TrainConfig(
        mesh=TMeshConfig(**mesh), **dict(kw, seq_len=128)))


def _worker_script(mod, fmod) -> list:
    out = []
    idx = mod.CompileCacheIndex()
    compiled = []
    worker = mod.PrecompileWorker(idx, compile_fn=compiled.append)
    try:
        out.append(worker.request("k1", label="lay1"))
        assert _wait(lambda: worker.status("k1") == "warm")
        out += [idx.is_warm("k1"), compiled[0].key, idx.entries()[0]["last_via"],
                worker.request("k1")]
        fmod.activate(fmod.FaultPlan(seed=7, specs=[fmod.FaultSpec(
            kind="precompile-error", at_step=0)]))
        out.append(worker.request("k2"))
        assert _wait(lambda: worker.status("k2") == "failed")
        out += [idx.is_warm("k2"), worker.request("k2")]
        assert _wait(lambda: worker.status("k2") == "warm")
        st = worker.stats()
        out.append({k: st[k] for k in ("completed_total", "failed_total", "started_total")})
    finally:
        fmod.clear_active()
        worker.shutdown()
    gate = []
    bounded = mod.PrecompileWorker(mod.CompileCacheIndex(), compile_fn=lambda t: gate.append(t)
                                   or time.sleep(0.5), max_pending=1)
    try:
        out += [bounded.request("x"), bounded.request("y"), bounded.stats()["rejected_total"]]
    finally:
        bounded.shutdown()
    return out


def test_precompile_worker_matches_jax():
    assert _worker_script(tci, tfaults) == _worker_script(jci, jfaults)


def test_default_precompile_builds_nothing_on_the_cpu():
    task = tci.PrecompileTask("k", "lay", TrainConfig(model_name="gpt-tiny"), 1, 0.0)
    if not torch.cuda.is_available():
        with pytest.raises(tci.PrecompileError, match="no CUDA device"):
            tci._default_precompile(task)
    with pytest.raises(tci.PrecompileError, match="no config"):
        tci._default_precompile(tci.PrecompileTask("k", "lay", None, 1, 0.0))


@pytest.fixture
def fresh_cache(monkeypatch):
    """The build directory module state as a fresh process has it."""
    monkeypatch.setattr(tcc, "_enabled_dir", None)
    monkeypatch.setattr(_flash_cuda, "BUILD_DIR", _flash_cuda.BUILD_DIR)
    tci.reset_index()
    yield
    tci.reset_index()


def test_compile_cache_enable_and_repoint(tmp_path, fresh_cache):
    """``force`` (what a card does by itself): the build directory moves,
    the index's sidecar follows; the same directory again changes nothing;
    another one is a re-point."""
    first = tcc.enable_compilation_cache(str(tmp_path / "a"), force=True)
    assert first == str(tmp_path / "a") and first.changed and not first.repointed
    assert _flash_cuda.BUILD_DIR == tmp_path / "a" and tcc.cache_dir_in_use() == first.dir
    assert _flash_cuda.library_path().parent == tmp_path / "a"
    assert tci.get_index().path == str(tmp_path / "a" / tci.SIDECAR_NAME)
    again = tcc.enable_compilation_cache(str(tmp_path / "a"))
    assert again.enabled and not again.changed
    moved = tcc.enable_compilation_cache(str(tmp_path / "b"), force=True)
    assert moved.repointed and moved.changed and _flash_cuda.BUILD_DIR == tmp_path / "b"
    assert tcc.CacheEnableResult(dir="x", enabled=True) == "x"


def test_compile_cache_without_a_device(tmp_path, fresh_cache, monkeypatch):
    """No CUDA device: nothing moves, and the result says why (JAX's CPU
    backend result, its reason renamed); forced without a directory, the
    package's default."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    default = _flash_cuda.BUILD_DIR
    res = tcc.enable_compilation_cache(str(tmp_path / "c"))
    assert not res and res.dir is None and res.skipped_reason == "no-cuda-device"
    assert not res.changed and _flash_cuda.BUILD_DIR == default
    assert tcc.DEFAULT_CACHE_DIR == str(default)
    monkeypatch.setattr(tcc, "DEFAULT_CACHE_DIR", str(tmp_path / "default"))
    assert tcc.enable_compilation_cache(force=True) == str(tmp_path / "default")
