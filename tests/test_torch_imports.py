"""The port stands alone: importing every module of ``tpu_engine_torch``
loads neither ``jax`` nor the JAX package ``tpu_engine``."""

import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch").set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]

_PROBE = """
import importlib, pkgutil, sys
import tpu_engine_torch
names = ["tpu_engine_torch"] + [m.name for m in pkgutil.walk_packages(
    tpu_engine_torch.__path__, "tpu_engine_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib")) or m == "tpu_engine"
             or m.startswith("tpu_engine."))
print(len(names), bad)
"""


def test_port_modules_import_neither_jax_nor_tpu_engine():
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    count, bad = out.stdout.strip().splitlines()[-1].split(" ", 1)
    assert bad == "[]", bad
    wanted = {"quant_train", "lora", "train", "serving", "generate", "quant", "offload",
              "disk_offload", "mesh_runtime", "sharding", "comm", "comm_compress", "checkpoint",
              "reshard", "data", "native", "historian", "journal", "tracing", "loss_monitor",
              "preemption", "faults", "compile_cache", "compile_index", "profiler", "telemetry",
              "tpu_manager", "hbm_estimate", "hetero", "supervisor", "goodput", "placement",
              "scheduler", "launcher"}
    have = {m.name.rsplit(".", 1)[-1] for m in pkgutil.walk_packages(
        [str(ROOT / "tpu_engine_torch")])}
    assert wanted <= have and int(count) >= len(have)
