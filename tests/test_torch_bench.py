"""``bench_torch.py``: the CPU run at a tiny size prints one config line and
bench.py's headline line, and without a card the default run exits
non-zero instead of falling back to the CPU."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]


def _bench(*args):
    return subprocess.run([sys.executable, str(ROOT / "bench_torch.py"), *args], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)


def test_cpu_run_prints_a_config_line_and_the_headline():
    out = _bench("--device", "cpu", "--model", "gpt-tiny", "--seq", "64", "--windows", "2",
                 "--iters", "1")
    assert out.returncode == 0, out.stderr
    lines = [json.loads(line) for line in out.stdout.splitlines() if line.startswith("{")]
    assert len(lines) == 2
    row, headline = lines
    assert row["config"] == {"model": "gpt-tiny", "micro_batch": 1, "seq_len": 64,
                             "moment_dtype": None, "loss_chunk_size": None, "attention": "xla"}
    assert len(row["step_ms_windows"]) == 2 and row["step_ms"] == min(row["step_ms_windows"])
    assert row["tokens_per_s"] > 0 and row["loss"] > 0
    assert row["mfu"] is None and row["peak_mem_gib"] is None  # no device metric on the CPU
    assert row["device"] == row["card"] == "cpu"
    assert {"metric", "value", "unit", "vs_baseline"} <= set(headline)
    assert headline["metric"] == "tokens_per_sec_gpt-tiny_cpu"
    assert headline["value"] == round(row["tokens_per_s"], 1)
    assert headline["vs_baseline"] == 0.0


def test_no_card_no_fallback():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default run would use it")
    out = _bench("--model", "gpt-tiny", "--seq", "64")
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr and "{" not in out.stdout
