"""Plant faults in the head-dim-256 flash-attention kernels on one card and
read what the kernel checks of ``chip_smoke.py`` measure for each, beside the
sound kernels in the same run. The D 256 limits there (``REL["bf16"]``, the
relative norm error against the plain version) are set from these readings.

    python3 kernel_faults.py

Each fault is a text patch of one kernel source that changes only the D 256
instantiations, built in a copy of the package under
``chip_checkout/kernel_faults/<fault>/`` (git-ignored) and loaded as a
module of its own, as ``kernel_ab.py`` loads a second tree:

- ``sound``: the sources as they are;
- ``o_rows_097``: K1 (``flash_fwd_sm90.cu``, its D 256 epilogue from
  registers) scales the output rows of the later half of the sequence by
  0.97;
- ``dq_rows_097``: K2 (``flash_bwd_dq_d256_sm90.cu``, its epilogue from
  registers) scales dQ's rows of the later half by 0.97;
- ``dkv_drop_q_tile``: K3 (``flash_bwd_dkv_d256_sm90.cu``) zeroes P^T of the
  last Q tile that each owned key tile sees, so that tile's contributions
  to dV and, through dS^T, to dK are lost.

Each is run at gemma-2b's training shape (B·H 4·8, S 2048, D 256, bf16,
causal) on the same inputs, with ``chip_smoke.check_case``'s plain
references: K1 against the plain forward, K2 and K3 on the plain forward's
lse and Δ. Prints the card's name and power limit, one line per fault with
the relative norm error and max |error| of o, dq, dk and dv, and one JSON
line, also written to ``chiprun_out/kernel_faults.json``.
"""

from __future__ import annotations

import importlib.util
import json
import shutil
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
WORK = ROOT / "chip_checkout" / "kernel_faults"
SHAPE = (32, 2048, 256)  # gemma-2b: B·H 4·8, S 2048, D 256

# (fault, [(source under csrc/, text in it, replacement)]): each replacement
# changes the D 256 instantiations only (K1's register epilogue and the K2
# and K3 files serve D 256 alone).
FAULTS = {
    "sound": [],
    "o_rows_097": [(
        "flash_fwd_sm90.cu",
        "store_row<D>(o + (static_cast<size_t>(bh) * S + row0 + 8 * h) * D, acc, h,\n"
        "                         1.0f / l[h], t);",
        "store_row<D>(o + (static_cast<size_t>(bh) * S + row0 + 8 * h) * D, acc, h,\n"
        "                         (row0 + 8 * h >= S / 2 ? 0.97f : 1.0f) / l[h], t);")],
    "dq_rows_097": [(
        "flash_bwd_dq_d256_sm90.cu",
        "                       acc, h, 1.0f, t);",
        "                       acc, h, row0 + r_in + 8 * h >= S / 2 ? 0.97f : 1.0f, t);")],
    "dkv_drop_q_tile": [(
        "flash_bwd_dkv_d256_sm90.cu",
        "              s[x] = p;",
        "              s[x] = i == hi ? 0.0f : p;")],
}


def _tree(fault: str) -> Path:
    """A copy of the package whose kernel source carries ``fault``."""
    tree = WORK / fault
    shutil.rmtree(tree, ignore_errors=True)
    shutil.copytree(ROOT / "tpu_engine_torch", tree / "tpu_engine_torch",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    for name, old, new in FAULTS[fault]:
        src = tree / "tpu_engine_torch" / "csrc" / name
        text = src.read_text()
        if text.count(old) != 1:
            raise AssertionError(f"{fault}: the patched text occurs {text.count(old)} times")
        src.write_text(text.replace(old, new))
    return tree


def _load(tree: Path, name: str):
    spec = importlib.util.spec_from_file_location(
        name, tree / "tpu_engine_torch" / "ops" / "_flash_cuda.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod._load()
    return mod


def _readings(fc, ref, q, k, v, do) -> dict:
    """Relative norm error and max |error| of each output of ``fc``'s
    kernels against the plain versions of ``ref``."""
    import torch

    po, plse = ref.flash_fwd_plain(q, k, v)
    delta = ref.flash_delta(po, do)
    got = {"o": fc.flash_fwd(q, k, v)[0], "dq": fc.flash_bwd_dq(q, k, v, do, plse, delta)}
    got["dk"], got["dv"] = fc.flash_bwd_dkv(q, k, v, do, plse, delta)
    want = {"o": po, "dq": ref.flash_bwd_dq_plain(q, k, v, do, plse, delta)}
    want["dk"], want["dv"] = ref.flash_bwd_dkv_plain(q, k, v, do, plse, delta)
    torch.cuda.synchronize()
    out = {}
    for n, a in got.items():
        diff = a.float() - want[n].float()
        out[n] = {"rel": float(diff.norm() / want[n].float().norm()),
                  "max_abs": float(diff.abs().max())}
    return out


def main() -> int:
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("kernel_faults: no CUDA device; this script runs only on the card", file=sys.stderr)
        return 2
    import chip_smoke as cs

    card = cs._card_line()
    print(card, flush=True)
    trees = {f: _tree(f) for f in FAULTS}
    # Build every tree at once: each build runs its compilers in parallel.
    from concurrent.futures import ThreadPoolExecutor

    mods = {}

    def build(fault):
        mods[fault] = _load(trees[fault], f"flash_{fault}")

    with ThreadPoolExecutor(len(trees)) as pool:
        list(pool.map(build, trees))
    q, k, v, do = cs._inputs(*SHAPE, torch.bfloat16, seed=0)
    res = {"card": card, "shape": list(SHAPE), "bound_rel": cs.REL["bf16"], "readings": {}}
    for fault, fc in mods.items():
        r = res["readings"][fault] = _readings(fc, mods["sound"], q, k, v, do)
        print(f"{fault}: " + " ".join(f"{n} rel {e['rel']:.3e} max {e['max_abs']:.3e}"
                                      for n, e in r.items()), flush=True)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "kernel_faults.json").write_text(json.dumps(res, indent=1))
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
