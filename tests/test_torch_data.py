"""Port parity: ``tpu_engine_torch/data.py`` and the native reader
(``tpu_engine_torch/native``) against ``tpu_engine/data.py``.

The port's native and numpy readers give batches bitwise JAX's for the
same file, seed and batch across an epoch boundary; its sharded stream
gives JAX's rows for each process index, a reassignment included; its
writers write JAX's bytes and sidecars; its refusals raise JAX's messages;
``make_data_fn`` hands the program int64 tensors on its device, and on a
mesh each rank's rows alone."""

import os
import re
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from tpu_engine import data as jdata  # noqa: E402
from tpu_engine_torch import data as tdata  # noqa: E402
from tpu_engine_torch import native as tnative  # noqa: E402

SEQ = 16


@pytest.fixture(scope="module")
def token_file(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("data") / "tokens.bin")
    toks = np.random.default_rng(0).integers(0, 50_000, 23 * SEQ + 5).astype(np.uint16)
    jdata.write_token_file(toks, path)
    return path


def test_native_library_builds():
    """``g++`` builds the port's copy of the reader into
    ``tpu_engine_torch/_build/``, and its host probe answers."""
    assert tnative.available(), tnative.build_error()
    assert tnative.build_error() is None
    lib = tnative.library_path()
    assert os.path.exists(lib) and os.sep + "tpu_engine_torch" + os.sep + "_build" in lib
    stats = tnative.host_stats()
    assert stats["n_cpus"] >= 1 and stats["mem_total_gb"] > 0


@pytest.mark.parametrize("native", [True, False], ids=["native", "numpy"])
@pytest.mark.parametrize("shuffle", [True, False])
def test_stream_bitwise_jax_across_epochs(token_file, native, shuffle):
    """Seven batches of 7 from 23 sequences cross two epoch boundaries
    mid-batch: every batch equals JAX's numpy reader's, and so does the
    epoch count (the native reader's counts the batch its prefetcher has
    read, one epoch ahead here once it has, as JAX's native reader's)."""
    want = jdata.TokenFileDataset(token_file, SEQ, prefer_native=False)
    got = tdata.TokenFileDataset(token_file, SEQ, prefer_native=native)
    assert got.native is native and got.num_sequences == want.num_sequences == 23
    want.start(7, seed=11, shuffle=shuffle)
    got.start(7, seed=11, shuffle=shuffle)
    for _ in range(7):
        np.testing.assert_array_equal(got.next_batch(), want.next_batch())
    assert want.epoch == 2 and got.epoch in ((2, 3) if native else (2,))
    idx = np.array([0, 22, 5])
    np.testing.assert_array_equal(got.read_batch(idx), want.read_batch(idx))
    got.close()
    want.close()


def test_shuffle_walk_equals_jax():
    for n, seed, epoch in ((1, 0, 0), (23, 11, 3), (100, 2**40 + 7, 1)):
        np.testing.assert_array_equal(tdata._shuffled_perm(n, seed, epoch),
                                      jdata._shuffled_perm(n, seed, epoch))


@pytest.mark.parametrize("pc", [2, 4])
def test_sharded_stream_rows_equal_jax(token_file, pc):
    """Each process index reads JAX's rows of each step, through a
    reassignment of the windows mid-run."""
    accum, gm = 2, 4
    ds = tdata.TokenFileDataset(token_file, SEQ)
    jds = jdata.TokenFileDataset(token_file, SEQ, prefer_native=False)
    for pi in range(pc):
        rows = gm // pc
        got = tdata._ShardedTokenStream(ds, accum, gm, pi * rows, rows, seed=3, prefetch=False)
        want = jdata._ShardedTokenStream(jds, accum, gm, pi * rows, rows, seed=3, prefetch=False)
        for step in range(5):
            if step == 3:  # a non-uniform window from here on
                got.reassign(0, gm - 1)
                want.reassign(0, gm - 1)
            np.testing.assert_array_equal(got.next(), want.next())
        assert got.epoch == want.epoch
        with pytest.raises(ValueError) as info:
            got.reassign(gm - 1, 2)
        with pytest.raises(ValueError, match=re.escape(str(info.value))):
            want.reassign(gm - 1, 2)
        got.close()
        want.close()


def test_writers_write_jax_bytes(tmp_path):
    """``write_token_file`` (1-D and 2-D with its sidecar),
    ``pack_sft_examples`` and ``tokenize_text_file`` (a stub tokenizer)
    write JAX's bytes."""

    class Tok:
        eos_token_id = 2

        def encode(self, line):
            return [ord(c) % 97 + 3 for c in line]

    text = tmp_path / "t.txt"
    text.write_text("hello world\r\n\nsecond line\n")
    n_t = tdata.tokenize_text_file(str(text), str(tmp_path / "p.bin"), Tok())
    n_j = jdata.tokenize_text_file(str(text), str(tmp_path / "j.bin"), Tok())
    assert n_t == n_j and (tmp_path / "p.bin").read_bytes() == (tmp_path / "j.bin").read_bytes()
    pairs = [([5, 6], [7, 8, 9]), ([1], [2, 3, 4, 5, 6, 7])]
    rows = tdata.pack_sft_examples(pairs, seq_len=8)
    np.testing.assert_array_equal(rows, jdata.pack_sft_examples(pairs, seq_len=8))
    for name, arr, dtype in (("flat", np.arange(100) % 700, "uint16"), ("rows", rows, "int32")):
        tdata.write_token_file(arr, str(tmp_path / f"{name}.p"), dtype=dtype)
        jdata.write_token_file(arr, str(tmp_path / f"{name}.j"), dtype=dtype)
        assert (tmp_path / f"{name}.p").read_bytes() == (tmp_path / f"{name}.j").read_bytes()
    meta = [(tmp_path / f"rows.{k}.meta.json").read_text() for k in "pj"]
    assert meta[0] == meta[1]
    assert not (tmp_path / "flat.p.meta.json").exists()


def _messages(fn_t, fn_j) -> tuple[str, str]:
    with pytest.raises(ValueError) as t:
        fn_t()
    with pytest.raises(ValueError) as j:
        fn_j()
    return str(t.value), str(j.value)


def test_rejections_raise_jax_messages(tmp_path, token_file):
    """The row-length sidecar at another seq_len, an out-of-range token,
    an overflowing tokenizer, an SFT row too long, a program of another
    seq_len and a bad row assignment: JAX's messages."""
    rows = jdata.pack_sft_examples([([5], [7, 8])] * 4, seq_len=8)
    sft = str(tmp_path / "sft.bin")
    jdata.write_token_file(rows, sft, dtype="int32")

    class Big:
        eos_token_id = None

        def encode(self, line):
            return [70_000]

    text = tmp_path / "t.txt"
    text.write_text("x\n")
    prog = SimpleNamespace(global_batch_shape=lambda: (1, 2, 32), device=torch.device("cpu"),
                           batch_sharding=None, runtime=None)
    cases = [
        (lambda m: m.TokenFileDataset(sft, seq_len=16, dtype="int32")),
        (lambda m: m.write_token_file(rows.reshape(-1), str(tmp_path / "bad.bin"))),
        (lambda m: m.write_token_file(np.array([70000]), str(tmp_path / "big.bin"))),
        (lambda m: m.tokenize_text_file(str(text), str(tmp_path / "o.bin"), Big())),
        (lambda m: m.pack_sft_examples([([1] * 6, [2] * 6)], seq_len=8)),
        (lambda m: m.pack_sft_examples([([-1], [2])], seq_len=8)),
        (lambda m: m.make_data_fn(prog, m.TokenFileDataset(token_file, SEQ))),
        (lambda m: m.validate_row_assignment([1, 2], 4, 2)),
        (lambda m: m.validate_row_assignment([4], 4, 2)),
        (lambda m: m.validate_row_assignment([0, 4], 4, 2)),
    ]
    for case in cases:
        got, want = _messages(lambda: case(tdata), lambda: case(jdata))
        assert got == want


def _program(rows: int, runtime=None):
    return SimpleNamespace(global_batch_shape=lambda: (2, rows, SEQ), device=torch.device("cpu"),
                           runtime=runtime)


def test_make_data_fn_one_process_equals_jax(token_file):
    """One process: the global batch, JAX's, as int64 on the program's
    device; the reader it runs is named; the eval batches equal JAX's."""
    import jax

    from tpu_engine.mesh_runtime import MeshRuntime

    jprog = SimpleNamespace(global_batch_shape=lambda: (2, 4, SEQ),
                            batch_sharding=MeshRuntime(devices=jax.devices()[:1]).replicated())
    for native in (True, False):
        fn = tdata.make_data_fn(_program(4), tdata.TokenFileDataset(token_file, SEQ,
                                                                    prefer_native=native), seed=5)
        jfn = jdata.make_data_fn(jprog, jdata.TokenFileDataset(token_file, SEQ), seed=5)
        assert fn.reader == ("native" if native else "numpy")
        for step in range(4):
            b = fn(step)
            assert b.dtype == torch.int64 and b.device.type == "cpu" and b.shape == (2, 4, SEQ)
            np.testing.assert_array_equal(b.numpy(), np.asarray(jfn(step)))
        fn.close()
    efn = tdata.make_eval_data_fn(_program(4), tdata.TokenFileDataset(token_file, SEQ))
    jefn = jdata.make_eval_data_fn(jprog, jdata.TokenFileDataset(token_file, SEQ))
    for i in range(3):
        np.testing.assert_array_equal(efn(i).numpy(), np.asarray(jefn(i)))
    syn = tdata.make_data_fn(_program(4), tdata.SyntheticDataset(512, SEQ), seed=1)
    assert syn.reader == "synthetic"
    jsyn = jdata.make_data_fn(jprog, jdata.SyntheticDataset(512, SEQ), seed=1)
    np.testing.assert_array_equal(syn(0).numpy(), np.asarray(jsyn(0)))


def test_make_data_fn_mesh_rank_reads_its_rows(token_file):
    """On a mesh of (data=2, fsdp=2) × model=2 each rank reads its rows of
    JAX's global stream, [accum, micro, S]: the row index is the rank's
    (data, fsdp) coordinate, ranks differing in ``model`` read alike. An
    unequal row assignment raises ``NotImplementedError``."""
    gm = 8
    jds = jdata.TokenFileDataset(token_file, SEQ, prefer_native=False)
    jds.start(2 * gm, seed=7)
    want = [jds.next_batch().reshape(2, gm, SEQ) for _ in range(3)]
    for d in range(2):
        for f in range(2):
            for m in range(2):
                rt = SimpleNamespace(data_parallel_size=lambda: 4,
                                     coords={"data": d, "fsdp": f, "model": m},
                                     axis_sizes={"data": 2, "fsdp": 2, "model": 2})
                fn = tdata.make_data_fn(_program(gm, rt), tdata.TokenFileDataset(token_file, SEQ),
                                        seed=7)
                i = d * 2 + f
                for step in range(3):
                    np.testing.assert_array_equal(fn(step).numpy(),
                                                  want[step][:, 2 * i:2 * i + 2])
                with pytest.raises(NotImplementedError, match="heterogeneous rebalancer"):
                    fn.reassign([1, 3, 2, 2])
                assert fn.reassign([2, 2, 2, 2]) == [2, 2, 2, 2]
                fn.close()
    with pytest.raises(NotImplementedError, match="non-uniform"):
        tdata.make_data_fn(_program(gm, rt), tdata.TokenFileDataset(token_file, SEQ),
                           row_assignment=[1, 3, 2, 2])
