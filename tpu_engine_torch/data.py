"""Input pipeline of the port: token files → batches on the program's
device (port of ``tpu_engine/data.py``).

- :func:`write_token_file`, :func:`tokenize_text_file`,
  :func:`pack_sft_examples` — the flat binary token format (uint16 or
  int32) and its row-length sidecar;
- :class:`TokenFileDataset` — sequences of a token file, read through the
  native mmap + prefetch reader (``tpu_engine_torch/native``) where ``g++``
  built it, else a numpy memmap reader with the same deterministic shuffle;
- :class:`SyntheticDataset` — deterministic random tokens;
- :func:`make_data_fn` — a dataset as the ``data_fn(step)`` of a program:
  one process reads the step's global batch; on a mesh each rank reads
  only its rows of the deterministic global stream
  (:class:`_ShardedTokenStream`), the stream's processes being the ranks
  of (``data``, ``fsdp``): ranks that differ only in ``model``,
  ``sequence`` or ``pipe`` read the same rows.

The batches are int64 tensors on the program's device (the card unless
the program runs on the CPU).
"""

from __future__ import annotations

import json
import os
import threading
from typing import Any, Callable, Optional

import numpy as np
import torch

from tpu_engine_torch import native

_DTYPE_CODES = {"uint16": 2, "int32": 4}
_NP_DTYPES = {"uint16": np.uint16, "int32": np.int32}


def write_token_file(tokens: np.ndarray, path: str, dtype: str = "uint16") -> str:
    """Serialize a token array to the flat binary format both readers use.

    Values outside the target dtype's range are rejected rather than
    silently wrapped — in particular, SFT-masked streams
    (:func:`pack_sft_examples`) carry negative codes and must be written
    with ``dtype="int32"``; a uint16 cast would corrupt every masked
    position into a large positive token id with no error anywhere
    downstream.

    A 2-D ``[n, row_len]`` array (row-structured data — packed SFT
    examples) additionally writes a ``<path>.meta.json`` sidecar recording
    the row length: rows are only meaningful if the training config slices
    the stream at exactly that seq_len, and :class:`TokenFileDataset`
    enforces the sidecar at open time instead of silently misaligning
    masks.
    """
    arr = np.asarray(tokens)
    info = np.iinfo(_NP_DTYPES[dtype])
    lo, hi = int(arr.min(initial=0)), int(arr.max(initial=0))
    if lo < info.min or hi > info.max:
        raise ValueError(
            f"token values [{lo}, {hi}] do not fit dtype {dtype} "
            f"[{info.min}, {info.max}]"
            + ("; SFT-masked streams need dtype='int32'" if lo < 0 else "")
        )
    if arr.ndim == 2:
        with open(path + ".meta.json", "w") as f:
            json.dump({"row_len": int(arr.shape[1]), "dtype": dtype}, f)
    elif arr.ndim == 1:
        # Rewriting a row-structured path with a plain stream must not
        # leave a stale sidecar vetoing valid seq_len choices.
        try:
            os.remove(path + ".meta.json")
        except FileNotFoundError:
            pass
    else:
        raise ValueError(f"tokens must be 1-D or 2-D, got shape {arr.shape}")
    arr.astype(_NP_DTYPES[dtype]).tofile(path)
    return path


def tokenize_text_file(
    text_path: str,
    out_path: str,
    tokenizer: Any,
    dtype: str = "uint16",
    append_eos: bool = True,
) -> int:
    """Tokenize a text file (one document per line) into the flat binary
    token format, streaming — the whole corpus is never held in memory.

    ``tokenizer`` is anything with an ``encode`` method: a HF
    ``PreTrainedTokenizer(Fast)`` loaded from a local directory, or a raw
    ``tokenizers.Tokenizer``. Returns the number of tokens written.
    ``dtype="uint16"`` requires every id < 65536 (checked).
    """
    np_dtype = _NP_DTYPES[dtype]
    limit = np.iinfo(np_dtype).max
    eos_id = getattr(tokenizer, "eos_token_id", None)
    total = 0
    with open(text_path, "r", encoding="utf-8") as fin, open(out_path, "wb") as fout:
        for line in fin:
            line = line.rstrip("\r\n")  # CRLF corpora must not leak \r tokens
            if not line:
                continue
            enc = tokenizer.encode(line)
            ids = enc if isinstance(enc, list) else enc.ids  # HF vs raw tokenizers
            if append_eos and eos_id is not None:
                ids = list(ids) + [eos_id]
            arr = np.asarray(ids, dtype=np.int64)
            if arr.size and int(arr.max()) > limit:
                raise ValueError(
                    f"token id {int(arr.max())} exceeds {dtype} range; use dtype='int32'"
                )
            fout.write(arr.astype(np_dtype).tobytes())
            total += int(arr.size)
    return total


def _splitmix64(state: np.uint64) -> tuple[np.uint64, np.uint64]:
    """One splitmix64 step — must match the native RNG bit-for-bit so the
    Python fallback yields the identical shuffle order."""
    mask = np.uint64(0xFFFFFFFFFFFFFFFF)
    state = (state + np.uint64(0x9E3779B97F4A7C15)) & mask
    z = state
    z = ((z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)) & mask
    z = ((z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)) & mask
    return state, z ^ (z >> np.uint64(31))


def _shuffled_perm(n: int, seed: int, epoch: int) -> np.ndarray:
    """Fisher–Yates with splitmix64 — identical to Reader::reshuffle()."""
    perm = np.arange(n, dtype=np.int64)
    state = np.uint64(seed) ^ (np.uint64(0xA5A5A5A5) * np.uint64(epoch + 1))
    with np.errstate(over="ignore"):
        for i in range(n - 1, 0, -1):
            state, z = _splitmix64(state)
            j = int(z % np.uint64(i + 1))
            perm[i], perm[j] = perm[j], perm[i]
    return perm


class _PermWalk:
    """The deterministic shuffle walk every stream shares: per-epoch
    permutation keyed by (seed, epoch) with mid-batch epoch wrap —
    bit-identical to ``Reader::next_batch`` in the native C++ reader.
    One implementation, consumed by :class:`_PyTokenReader` (single-host
    sequential stream) AND :class:`_ShardedTokenStream` (multi-host
    sharded reads), so the two can never silently de-synchronise."""

    def __init__(self, n: int, seed: int, shuffle: bool):
        self.n, self.seed, self.shuffle = int(n), int(seed), shuffle
        self.epoch = 0
        self._cursor = 0
        self._perm = self._make_perm()

    def _make_perm(self) -> np.ndarray:
        if self.shuffle:
            return _shuffled_perm(self.n, self.seed, self.epoch)
        return np.arange(self.n, dtype=np.int64)

    def next_indices(self, k: int) -> np.ndarray:
        out = np.empty(k, dtype=np.int64)
        for i in range(k):
            if self._cursor >= self.n:
                self.epoch += 1
                self._cursor = 0
                self._perm = self._make_perm()
            out[i] = self._perm[self._cursor]
            self._cursor += 1
        return out


class _PyTokenReader:
    """NumPy-memmap fallback with the same stream semantics as the native
    reader (deterministic epoch shuffle, sequential cursor)."""

    def __init__(self, path: str, seq_len: int, dtype: str):
        self.seq_len = int(seq_len)
        self._mm = np.memmap(path, dtype=_NP_DTYPES[dtype], mode="r")
        self.num_tokens = int(self._mm.shape[0])
        self.num_sequences = self.num_tokens // self.seq_len
        if self.num_sequences < 1:
            raise FileNotFoundError(f"{path}: smaller than one sequence")
        self._batch: Optional[int] = None
        self._walk: Optional[_PermWalk] = None

    @property
    def epoch(self) -> int:
        return self._walk.epoch if self._walk is not None else 0

    def read_batch(self, indices: np.ndarray, n_threads: int = 0) -> np.ndarray:
        out = np.empty((len(indices), self.seq_len), dtype=np.int32)
        for i, idx in enumerate(np.asarray(indices, dtype=np.int64)):
            if not 0 <= idx < self.num_sequences:
                raise IndexError(f"sequence index {idx} out of range")
            out[i] = self._mm[idx * self.seq_len:(idx + 1) * self.seq_len]
        return out

    def start_prefetch(self, batch: int, seed: int = 0, shuffle: bool = True) -> None:
        if batch > self.num_sequences:
            raise ValueError("batch > num_sequences")
        self._batch = int(batch)
        self._walk = _PermWalk(self.num_sequences, seed, shuffle)

    def next_batch(self) -> np.ndarray:
        if self._batch is None or self._walk is None:
            raise RuntimeError("call start_prefetch first")
        return self.read_batch(self._walk.next_indices(self._batch))

    def close(self) -> None:
        self._mm = None


class TokenFileDataset:
    """Sequences from a flat binary token file; native reader when possible.

    The stream is deterministic given (seed, batch): restarting after a crash
    replays the same shuffle order, so resume-from-checkpoint sees the data
    it would have seen (the step index keys the stream position).
    """

    def __init__(self, path: str, seq_len: int, dtype: str = "uint16",
                 prefer_native: bool = True):
        if dtype not in _DTYPE_CODES:
            raise ValueError(f"dtype must be one of {sorted(_DTYPE_CODES)}")
        if not os.path.exists(path):
            raise FileNotFoundError(path)
        # Row-structured files (packed SFT examples) carry a sidecar with
        # their row length; slicing them at any other seq_len would split
        # rows and silently shift mask boundaries.
        meta_path = path + ".meta.json"
        if os.path.exists(meta_path):
            try:
                with open(meta_path) as f:
                    meta = json.load(f)
            except (OSError, ValueError):
                meta = {}
            row_len = meta.get("row_len")
            if row_len is not None and int(row_len) != int(seq_len):
                raise ValueError(
                    f"{path} was written with row_len={row_len} "
                    f"(see {meta_path}); reading it at seq_len={seq_len} "
                    "would misalign rows and SFT mask boundaries"
                )
        self.path, self.seq_len, self.dtype = path, int(seq_len), dtype
        self.native = False
        if prefer_native and native.available():
            self._reader: Any = native.NativeTokenReader(
                path, seq_len, _DTYPE_CODES[dtype]
            )
            self.native = True
        else:
            self._reader = _PyTokenReader(path, seq_len, dtype)

    @property
    def num_sequences(self) -> int:
        return self._reader.num_sequences

    @property
    def num_tokens(self) -> int:
        return self._reader.num_tokens

    @property
    def epoch(self) -> int:
        return self._reader.epoch

    def read_batch(self, indices: np.ndarray) -> np.ndarray:
        return self._reader.read_batch(np.asarray(indices, dtype=np.int64))

    def start(self, batch: int, seed: int = 0, shuffle: bool = True) -> None:
        self._reader.start_prefetch(batch, seed, shuffle)

    def next_batch(self) -> np.ndarray:
        return self._reader.next_batch()

    def close(self) -> None:
        self._reader.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class SyntheticDataset:
    """Deterministic random tokens (the default when no dataset is given)."""

    def __init__(self, vocab_size: int, seq_len: int):
        self.vocab_size, self.seq_len = vocab_size, seq_len
        self._batch: Optional[int] = None
        self._seed = 0
        self._step = 0

    def start(self, batch: int, seed: int = 0, shuffle: bool = True) -> None:
        self._batch, self._seed, self._step = int(batch), int(seed), 0

    def next_batch(self) -> np.ndarray:
        if self._batch is None:
            raise RuntimeError("call start first")
        rng = np.random.default_rng((self._seed << 20) ^ self._step)
        self._step += 1
        return rng.integers(
            0, self.vocab_size, (self._batch, self.seq_len), dtype=np.int32
        )

    def close(self) -> None:
        pass


class _ShardedTokenStream:
    """Per-process view of the deterministic global sample stream.

    Every process derives the SAME (seed, epoch)-keyed permutation walk the
    single-host readers use, but only this process's contiguous row block
    of each step's [accum, global_micro] index matrix is actually READ —
    per-process I/O volume scales as 1/process_count instead of every host
    reading (and then discarding most of) the full global batch (at 64
    hosts, 64x redundant reads a step, and every host holding the whole
    token file). In the port a process is a rank of (``data``, ``fsdp``).

    A one-deep background prefetch thread hides the read behind the
    previous step's compute, preserving the latency-hiding the readers'
    own prefetch pipelines provide on the single-host path.
    """

    def __init__(self, dataset: Any, accum: int, global_micro: int,
                 row_start: int, row_count: int, seed: int,
                 shuffle: bool = True, prefetch: bool = True):
        n = dataset.num_sequences
        batch = accum * global_micro
        if batch > n:
            raise ValueError(f"batch {batch} > num_sequences {n}")
        self._ds = dataset
        self._accum, self._gm = accum, global_micro
        # One tuple, swapped atomically: the prefetch thread reads the
        # window mid-step and a reassign must never hand it a torn
        # (new start, old count) pair.
        self._window = (int(row_start), int(row_count))
        self._walk = _PermWalk(n, seed, shuffle)
        self._queue: Any = None
        self._dead: Optional[Exception] = None
        if prefetch:
            import queue as _queue

            self._queue = _queue.Queue(maxsize=1)
            self._stop = threading.Event()
            self._thread = threading.Thread(
                target=self._producer, daemon=True, name="sharded-data-prefetch"
            )
            self._thread.start()

    @property
    def epoch(self) -> int:
        return self._walk.epoch

    def reassign(self, row_start: int, row_count: int) -> None:
        """Move this process's row window (heterogeneous rebalance).

        The walk itself is untouched — every process still derives the
        identical global index matrix each step, so as long as all
        processes reassign at the same step boundary the global batch
        stays covered exactly once. With prefetch on, the one in-flight
        batch was read under the old window; the new window takes effect
        from the next produced batch — the same step skew on every
        process, because the prefetch depth is fixed at one.
        """
        r0, rows = int(row_start), int(row_count)
        if rows < 1 or r0 < 0 or r0 + rows > self._gm:
            raise ValueError(
                f"row window [{r0}, {r0 + rows}) outside global micro "
                f"batch of {self._gm} rows"
            )
        self._window = (r0, rows)

    def _read_local(self) -> np.ndarray:
        r0, rows = self._window
        g = self._walk.next_indices(self._accum * self._gm).reshape(
            self._accum, self._gm
        )
        block = g[:, r0:r0 + rows]  # [accum, rows]
        flat = self._ds.read_batch(block.reshape(-1))
        return flat.reshape(self._accum, rows, -1)

    def _producer(self) -> None:
        while not self._stop.is_set():
            try:
                item = self._read_local()
            except Exception as e:  # surface in next(); never die silently
                item = e
            while not self._stop.is_set():
                try:
                    self._queue.put(item, timeout=0.2)
                    break
                except Exception:
                    continue
            if isinstance(item, Exception):
                return

    def next(self) -> np.ndarray:
        """This process's [accum, rows, seq] slab for the next step."""
        if self._queue is None:
            return self._read_local()
        if self._dead is not None:
            # The producer delivered an exception and exited; re-raise on
            # every later call instead of blocking forever on an empty
            # queue (a retry loop around data_fn would otherwise deadlock).
            raise self._dead
        item = self._queue.get()
        if isinstance(item, Exception):
            self._dead = item
            raise item
        return item

    def close(self) -> None:
        if self._queue is not None:
            self._stop.set()
            try:
                while True:
                    self._queue.get_nowait()
            except Exception:
                pass
            self._thread.join(timeout=2.0)


def validate_row_assignment(
    assignment: Any, global_micro: int, process_count: int, accum: int = 1
) -> list[int]:
    """Validate a non-uniform rows-per-process vector (heterogeneous
    sharding): one positive entry per process,
    summing to the declared global micro batch exactly — a bad vector
    would silently drop or double-read rows of every step's
    ``accum × global_micro`` batch, so it is rejected loudly instead."""
    rows = [int(r) for r in assignment]
    if len(rows) != process_count:
        raise ValueError(
            f"row assignment has {len(rows)} entries for "
            f"{process_count} processes"
        )
    if any(r < 1 for r in rows):
        raise ValueError(f"row assignment entries must be >= 1, got {rows}")
    if sum(rows) != int(global_micro):
        raise ValueError(
            f"row assignment {rows} covers {accum} x {sum(rows)} rows per "
            f"step, expected accum x global micro batch = "
            f"{accum} x {global_micro}"
        )
    return rows


def _check_seq_len(dataset: Any, seq_len: int) -> None:
    if dataset.seq_len != seq_len:
        raise ValueError(
            f"dataset seq_len {dataset.seq_len} != program seq_len {seq_len}"
        )


def _check_stream_assignment_feasible(rows: list[int], global_micro: int, pc: int) -> None:
    """JAX's rule for a sharded stream on a runtime of several processes: a
    rank reads only its own row window, so a row vector is placeable only
    where it equals the fixed per-process batch partition, the equal
    split here (each rank steps on ``micro_batch_size`` rows of each
    microbatch). Any other vector raises JAX's ``ValueError``, which the
    supervisor audits as ``hetero_reassign_rejected``, keeping the old
    split."""
    partition = [global_micro // pc] * pc
    if rows != partition:
        raise ValueError(
            f"row assignment {rows} does not match the sharding's per-process "
            f"batch partition {partition}; a sharded stream cannot place rows "
            "its own devices do not address (heterogeneous sharding is limited "
            "to partition-compatible assignments on multi-host runtimes)"
        )


def _reader_of(dataset: Any) -> str:
    if isinstance(dataset, TokenFileDataset):
        return "native" if dataset.native else "numpy"
    return "synthetic" if isinstance(dataset, SyntheticDataset) else type(dataset).__name__


def _row_rank(program: Any) -> tuple[int, int]:
    """(row ranks, this rank's index): the ranks of (``data``, ``fsdp``)."""
    rt = getattr(program, "runtime", None)
    if rt is None:
        return 1, 0
    return rt.data_parallel_size(), rt.coords["data"] * rt.axis_sizes["fsdp"] + rt.coords["fsdp"]


def make_data_fn(
    program: Any,
    dataset: Any,
    seed: int = 0,
    *,
    process_count: Optional[int] = None,
    process_index: Optional[int] = None,
    row_assignment: Optional[Any] = None,
) -> Callable[[int], torch.Tensor]:
    """A dataset as the program's ``data_fn(step)``: the tensor its step
    takes, on ``program.device``.

    One process: ``accum × global_micro`` sequences a step from the
    (shuffled, prefetching) stream, as [accum, global_micro, seq_len].
    On a mesh with a random-access dataset (``read_batch``): each rank
    reads only its rows of the deterministic global stream
    (:class:`_ShardedTokenStream`), [accum, micro_batch, seq_len], which the
    step takes as the rank's own. ``process_count``/``process_index``
    override the mesh's row ranks (a test seam).

    ``row_assignment``: rows a row rank, validated
    (:func:`validate_row_assignment`). A sharded stream takes JAX's rule
    for several processes: only the sharding's per-process partition, the
    equal split; another vector raises JAX's ``ValueError`` at
    construction and in ``reassign``. The synthetic path takes any valid
    vector, as JAX's whole-array placement does: every rank holds the
    whole batch, so the step's math is unchanged. The returned function has ``reader``
    (``"native"``, ``"numpy"``, ``"synthetic"``), ``reassign(assignment)``
    and ``close()``.
    """
    accum, global_micro, seq_len = program.global_batch_shape()
    _check_seq_len(dataset, seq_len)
    n_rows, index = _row_rank(program)
    pc = process_count if process_count is not None else n_rows
    pi = process_index if process_index is not None else index
    device = program.device

    def on_device(batch: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(batch).to(device=device, dtype=torch.long)

    if pc > 1 and hasattr(dataset, "read_batch"):
        if row_assignment is not None:
            rows_vec = validate_row_assignment(row_assignment, global_micro, pc, accum)
            _check_stream_assignment_feasible(rows_vec, global_micro, pc)
        else:
            if global_micro % pc != 0:
                raise ValueError(
                    f"global micro batch {global_micro} not divisible by "
                    f"process count {pc}"
                )
            rows_vec = [global_micro // pc] * pc
        stream = _ShardedTokenStream(
            dataset, accum, global_micro, sum(rows_vec[:pi]), rows_vec[pi], seed
        )

        def data_fn(step: int) -> torch.Tensor:
            return on_device(stream.next())  # [accum, rows, seq_len]

        def reassign(assignment: Any) -> list[int]:
            rv = validate_row_assignment(assignment, global_micro, pc, accum)
            _check_stream_assignment_feasible(rv, global_micro, pc)
            stream.reassign(sum(rv[:pi]), rv[pi])
            return rv

        data_fn.close = stream.close  # type: ignore[attr-defined]
        data_fn.reassign = reassign  # type: ignore[attr-defined]
        data_fn.reader = _reader_of(dataset)  # type: ignore[attr-defined]
        return data_fn

    dataset.start(accum * global_micro, seed=seed)
    assign_box: list[Optional[list[int]]] = [
        validate_row_assignment(row_assignment, global_micro, pc, accum)
        if row_assignment is not None else None
    ]

    def data_fn(step: int) -> torch.Tensor:
        flat = dataset.next_batch()  # [accum*global_micro, seq_len] int32
        return on_device(flat.reshape(accum, global_micro, seq_len))

    def reassign(assignment: Any) -> list[int]:
        assign_box[0] = validate_row_assignment(assignment, global_micro, pc, accum)
        return assign_box[0]

    data_fn.reassign = reassign  # type: ignore[attr-defined]
    data_fn.close = dataset.close  # type: ignore[attr-defined]
    data_fn.reader = _reader_of(dataset)  # type: ignore[attr-defined]
    return data_fn


def make_eval_data_fn(program: Any, dataset: "TokenFileDataset") -> Callable[[int], torch.Tensor]:
    """Fixed held-out batches: call ``i`` always reads the same sequences
    (the i-th contiguous block of the file, wrapping), the global batch on
    the program's device."""
    accum, global_micro, seq_len = program.global_batch_shape()
    _check_seq_len(dataset, seq_len)
    bs = accum * global_micro

    def eval_fn(i: int) -> torch.Tensor:
        idx = (np.arange(bs, dtype=np.int64) + i * bs) % dataset.num_sequences
        flat = dataset.read_batch(idx)
        return torch.from_numpy(flat.reshape(accum, global_micro, seq_len)).to(
            device=program.device, dtype=torch.long)

    return eval_fn


# -- SFT packing -------------------------------------------------------------


def pack_sft_examples(
    pairs: "list[tuple[list[int], list[int]]]", seq_len: int
) -> np.ndarray:
    """Pack (prompt, completion) token pairs into fixed-length rows with
    in-band loss masking: prompt tokens are stored as ``-(t+1)`` (real
    context whose prediction is not trained on), completion tokens as-is,
    and padding as ``-1`` (masked token 0). The loss then trains only on
    predicting the completion — the standard SFT objective.

    The result is ``[n, seq_len] int32``; write it with
    :func:`write_token_file` using ``dtype="int32"`` (the masked encoding
    needs the sign bit — uint16 streams cannot carry masks). Writing the
    2-D array records ``seq_len`` in a ``.meta.json`` sidecar, and
    :class:`TokenFileDataset` refuses to open the file at any other
    seq_len — rows are only aligned when the training config's seq_len
    equals the packing seq_len.
    """
    rows = np.full((len(pairs), seq_len), -1, np.int32)
    for i, (prompt, completion) in enumerate(pairs):
        if any(t < 0 for t in prompt) or any(t < 0 for t in completion):
            raise ValueError(f"pair {i}: token ids must be >= 0")
        seq = [-(t + 1) for t in prompt] + list(completion)
        if len(seq) > seq_len:
            raise ValueError(
                f"pair {i}: prompt+completion is {len(seq)} tokens, "
                f"exceeds seq_len={seq_len} (truncating would silently "
                "change the example; split or shorten it)"
            )
        rows[i, : len(seq)] = np.asarray(seq, np.int32)
    return rows
