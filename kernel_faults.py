"""Plant faults in the flash-attention kernels on one card and read what the
kernel checks of ``chip_smoke.py`` measure for each, beside the sound kernels
in the same run. The limits there (``REL``, the relative norm error against
the plain version: ``REL["bf16"]`` at D 256, ``REL["fp32"]`` for the
split-TF32 fp32 kernels) are set from these readings.

    python3 kernel_faults.py

Each fault is a text patch of one kernel source that changes only the
instantiations of one head dim or dtype, built in a copy of the package under
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
  to dV and, through dS^T, to dK are lost;
- ``f32_one_pass``: the fp32 K1, K2 and K3 (``flash_f32_tc.cu``) keep only
  the hi·hi term of each split-TF32 product (``tf32_split.cuh``): plain TF32;
- ``f32_dq_drop_k_tile``: the fp32 K2 leaves the last streamed K/V tile's
  dS·K (16 keys) out of dQ, for every owned Q block;
- ``f32_dkv_drop_q_tile``: the fp32 K3 zeroes P^T of the last streamed Q
  tile (16 queries) that each owned key tile sees, so that tile's
  contributions to dV and, through dS^T, to dK are lost;
- ``k1_d32_drop_k_tile``: the bf16 K1 at D 32 (``flash_fwd_sm90.cu``)
  leaves out the last 128-key tile of every Q tile that sees more than one,
  from o and lse alike;
- ``k3_d32_drop_q_tile``: the bf16 K3 at D 32 (``flash_bwd_sm90.cu``)
  zeroes P^T and dS^T of the last streamed Q tile (64 queries) that each
  owned key tile sees;
- ``k2_d32_drop_k_tile``: the bf16 K2 at D 32 (``flash_bwd_sm90.cu``)
  zeroes dS of the last key tile (64 keys) that each consumer warpgroup's
  64 Q rows see (causal: their diagonal tile), so that tile's dS·K is lost
  from dQ.

The D 256 bf16 faults (and the sound tree) are read at gemma-2b's training
shape (B·H 4·8, S 2048, D 256, bf16, causal), the D 32 ones (and the sound
tree) at ``chip_smoke.OFF_PATH``'s bf16 D 32 shape (B·H 64, S 2048,
causal), the fp32 ones (and the sound tree) at ``chip_smoke.OFF_PATH``'s
causal fp32 shapes (S 2048: D 128 at B·H 64, D 256 at B·H 32), each on the
same inputs for every tree, with
``chip_smoke.check_case``'s plain references (TF32 off): K1 against the
plain forward, K2 and K3 on the plain forward's lse and Δ. Prints the
card's name and power limit, one line per fault and shape with the relative
norm error and max |error| of o, dq, dk and dv, and one JSON line, also
written to ``chiprun_out/kernel_faults.json``.
"""

from __future__ import annotations

import importlib.util
import json
import shutil
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
WORK = ROOT / "chip_checkout" / "kernel_faults"
# The shapes (B·H, S, D) each kind of fault is read at: gemma-2b's training
# shape in bf16 at D 256; chip_smoke.OFF_PATH's bf16 D 32 and fp32 rows.
SHAPES = {"bf16": ((32, 2048, 256),), "bf16_d32": ((64, 2048, 32),),
          "fp32": ((64, 2048, 128), (32, 2048, 256))}

# (fault, [(source under csrc/, text in it, replacement)]): the D 256 bf16
# ones change the D 256 instantiations only (K1's register epilogue and the
# K2 and K3 files serve D 256 alone), the D 32 ones test D == 32; the fp32
# ones change flash_f32_tc.cu's kernels, which serve fp32 alone.
_K1_STEP = "        softmax_step<kCausal, T::kChains>(s, m, l, corr, masked(j), j, row0, t, S,"
FAULTS = {
    "sound": [],
    "o_rows_097": [(
        "flash_fwd_sm90.cu",
        "store_row<D>(o + (static_cast<size_t>(bh) * S + row0 + 8 * h) * D, acc, h,\n"
        "                         1.0f / row_l[h], t);",
        "store_row<D>(o + (static_cast<size_t>(bh) * S + row0 + 8 * h) * D, acc, h,\n"
        "                         (D == 256 && row0 + 8 * h >= S / 2 ? 0.97f : 1.0f) / row_l[h],"
        " t);")],
    "dq_rows_097": [(
        "flash_bwd_dq_d256_sm90.cu",
        "                       acc, h, 1.0f, t);",
        "                       acc, h, row0 + r_in + 8 * h >= S / 2 ? 0.97f : 1.0f, t);")],
    "dkv_drop_q_tile": [(
        "flash_bwd_dkv_d256_sm90.cu",
        "              s[x] = p;",
        "              s[x] = i == hi ? 0.0f : p;")],
    "f32_one_pass": [(
        "tf32_split.cuh",
        "  mma_tf32(c, a.lo, b.hi);\n  mma_tf32(c, a.hi, b.lo);\n  mma_tf32(c, a.hi, b.hi);",
        "  mma_tf32(c, a.hi, b.hi);")],
    "f32_dq_drop_k_tile": [(
        "flash_f32_tc.cu",
        "        mma_split(dq_sum[n], dsa[kk], b);",
        "        if (u != u_hi) mma_split(dq_sum[n], dsa[kk], b);")],
    "f32_dkv_drop_q_tile": [(
        "flash_f32_tc.cu",
        "        if (masked && !visible(q0 + qi, kpos + 8 * (e >> 1), window)) p = 0.0f;",
        "        if ((masked && !visible(q0 + qi, kpos + 8 * (e >> 1), window)) || u == u_hi)"
        " p = 0.0f;")],
    "k1_d32_drop_k_tile": [(
        "flash_fwd_sm90.cu", _K1_STEP,
        "        if (D == 32 && j == hi)\n"
        "          for (int x = 0; x < kBlockN / 2; ++x) s[x] = kNegInf;\n" + _K1_STEP)],
    "k3_d32_drop_q_tile": [(
        "flash_bwd_sm90.cu",
        "            dp[4 * nn + e] = s[4 * nn + e] * fmaf(dp[4 * nn + e], scale, nd[e & 1]);",
        "          {\n"
        "            if (D == 32 && i == hi) s[4 * nn + e] = 0.0f;\n"
        "            dp[4 * nn + e] = s[4 * nn + e] * fmaf(dp[4 * nn + e], scale, nd[e & 1]);\n"
        "          }")],
    "k2_d32_drop_k_tile": [(
        "flash_bwd_sm90.cu",
        "            dp[x] = s[x] * fmaf(dp[x], scale, nd[(x >> 1) & 1]);",
        "            dp[x] = D == 32 && j == hi_c ? 0.0f : s[x] * fmaf(dp[x], scale, nd[(x >> 1) & 1]);")],
}


def _kind(fault: str) -> tuple[str, ...]:
    """The shapes' kinds a fault is read at: the sound tree at all."""
    if fault == "sound":
        return tuple(SHAPES)
    if fault.startswith("f32_"):
        return ("fp32",)
    return ("bf16_d32",) if "_d32_" in fault else ("bf16",)


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
    torch.backends.cuda.matmul.allow_tf32 = False
    res = {"card": card, "shapes": SHAPES, "bound_rel": cs.REL, "readings": {}}
    for kind, shapes in SHAPES.items():
        dtype = torch.float32 if kind == "fp32" else torch.bfloat16
        for shape in shapes:
            q, k, v, do = cs._inputs(*shape, dtype, seed=0)
            label = f"{kind} bh{shape[0]} s{shape[1]} d{shape[2]}"
            for fault, fc in mods.items():
                if kind not in _kind(fault):
                    continue
                r = _readings(fc, mods["sound"], q, k, v, do)
                res["readings"].setdefault(fault, {})[label] = r
                print(f"{fault} {label}: " + " ".join(
                    f"{n} rel {e['rel']:.3e} max {e['max_abs']:.3e}" for n, e in r.items()),
                    flush=True)
            del q, k, v, do
            torch.cuda.empty_cache()
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "kernel_faults.json").write_text(json.dumps(res, indent=1))
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
