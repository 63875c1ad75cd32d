"""Plant faults in the port's serving path on one card and read what the
serving checks of ``chip_smoke.py`` measure for each, beside the sound code
in the same run. ``SERVE_TAU``, ``INT8_SHARE`` and ``SPEC_ACCEPT_MIN``
there are set from these readings.

    python3 serve_faults.py          # llama-1b: streams, int8 pool, speculative
    python3 serve_faults.py --moe    # moe-8x7b in weight-only int8 (serve_moe)
    python3 serve_faults.py --mesh   # llama-1b on model=2 (serve_mesh)

llama-1b at full width and depth (seed-0 weights cast once to bf16) serves
the ``serve`` phase's 16 requests (``chip_smoke._serve_plan``, the same
``ContinuousBatcher`` options), driven by ``step`` on this thread.

Stream faults, read as the largest teacher-forced gap of the greedy streams
(``chip_smoke._stream_gap``; held to ``SERVE_TAU``):

- ``sound``, ``sound_int8``: the code as it is, with the bf16 and the int8
  pool;
- ``second_best``: every greedy decode draw takes the second-ranked token;
- ``rope_plus_one``: decode steps rotate q and k for position + 1.

int8 faults, read as the int8 pool's logits against the full-precision
pool's, max |difference| as a share of max |logit|
(``chip_smoke._pool_logits``; held to ``INT8_SHARE``), in bf16 compute and
in fp32 compute with TF32 off:

- ``sound``;
- ``scale_bf16``: the stored scales rounded to bf16 (codes from the exact
  scale);
- ``scale_127_128``: the stored scales times 127/128, as if the codes
  spanned ±128;
- ``dequant_skipped``: the stored scales 1, so the codes are read as values.

Speculative faults, on ``chip_smoke.py``'s ``serve_spec`` batcher
(``SPEC_CFG``: the same pool with a draft, ``spec_gamma`` 4, no prefix
cache) serving the 16 prompts all greedy (``chip_smoke._spec_plan``), with
llama-1b as its own draft and with the 2-layer draft of ``generate``; read
as the largest teacher-forced gap (held to ``SERVE_TAU``), the mean
accepted tokens per round (the own draft's held to ``SPEC_ACCEPT_MIN``) and
the rounds off the accepted frontier (``chip_smoke.spec_frontier``, held to
0):

- ``spec_sound``;
- ``spec_rewind_keeps_one``: after a round with a rejection, the target's
  rewind leaves one lane too many, so the first rejected lane stays
  visible;
- ``spec_draft_gamma_steps``: the draft runs ``gamma`` steps, not
  ``gamma + 1``, so the last proposal's K/V never reaches its pool.

MoE faults (``--moe``), on ``chip_smoke.py``'s ``serve_moe`` batcher:
moe-8x7b at full width and ``chip_smoke.SERVE_MOE_L`` layers in weight-only int8
(``chip_smoke._moe_int8_tree``, ``SERVE_MOE_CFG``) serving
``chip_smoke._serve_moe_plan``'s 16 greedy requests; read as the
teacher-forced gaps through forward with ragged dispatch and flash
attention (``chip_smoke._moe_gaps``): their median in bf16 (held to
``SERVE_MOE_TAU``), and the share of positions within ``SERVE_MOE_FP32``'s
gap of its shorter run in fp32 compute (``chip_smoke._moe_fp32_check``):

- ``moe_sound``;
- ``moe_top1``: MoE decode combines only the first expert, with its gate;
- ``moe_no_renorm``: MoE decode's top-k gates are not renormalised;
- ``int8_scale_dropped``: decode reads expert 0's down kernel without its
  scale (codes as values), in every layer.

Beside them, why the largest gap cannot be the check: decode against
forward (ragged dispatch) on one 320-token stream (a 256-token prefill,
then one-token steps, ``chip_smoke._cached_logits``), in bf16 and in fp32
compute: the tokens whose top-k experts differ between the two, per
layer, and the logits' relative error.

Mesh faults (``--mesh``), on ``chip_smoke.py``'s ``serve_mesh``: llama-1b
at ``SERVE_MESH_L`` layers on model=2, two ranks a process each on the one
card; read as the relative
norm error of the ranks' teacher-forced decode logits (``serve``'s first 8
prompts, 16 tokens from seed 1, ``chip_smoke._mesh_teacher``) against the
one-rank pool's on the same tokens (``chip_smoke.serve_mesh_rel``; held to
``SERVE_TP_REL``):

- ``mesh_sound``;
- ``mesh_down_g_dropped``: decode leaves the down projection's partial
  sums unsummed over ``model`` (``transformer._row_proj``), each rank
  adding its own half of the MLP;
- ``mesh_int8_scale_twice``: a row-split int8 site (o, down) applies its
  scale on both sides of the sum over ``model`` (each rank's partial
  product, as the package does, and the sum again).

Each mesh fault is read on the bf16 weights and on their weight-only int8
tree (``quant.quantize_params``; the batcher cuts it as JAX's
``quantize_pspecs`` splits it).

Each fault is a patch of one function of the package for its own run; no
file changes. Prints the card's name and power limit, one line per reading
and one JSON line, also written to ``chiprun_out/serve_faults.json``.
"""

from __future__ import annotations

import contextlib
import json
import sys
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parent


def _second_best(real):
    def pick(logits, temps, req_ids, counts, seed):
        second = logits.topk(2, dim=-1).indices[:, 1]
        return real(logits, temps, req_ids, counts, seed).where(temps > 0.0, second)

    return pick


def _rope_plus_one(real):
    def run(params, x, cache, write, hidden, positions, *rest):
        return real(params, x, cache, write, hidden, positions + 1, *rest)

    return run


def _rewind_keeps_one(real):
    def rewind(cache, draft_cache, overshoot):
        real(cache, draft_cache, overshoot)
        cache.lengths += overshoot > 0

    return rewind


def _draft_gamma_steps(real):
    def propose(draft_params, tokens, draft_cache, active, draft_cfg, n_steps, dtype):
        import torch

        props, draft_cache = real(draft_params, tokens, draft_cache, active, draft_cfg,
                                  n_steps - 1, dtype)
        return torch.cat([props, props[:, -1:]], dim=1), draft_cache

    return propose


# serve_mesh's bound on the teacher-forced decode logits on model=2 against
# one rank (relative norm error): set between the sound reading and the
# planted faults' (``--mesh``): 1.286e-2 and 1.091 at 4 layers (the down
# projection's sum dropped), 1.834e-2 and 1.165 at 8, 2.517e-2 and 1.188 at
# 16; the int8 tree at 4 layers 1.502e-2 and 1.321 (a row-split scale on
# both sides of the sum); at 2 layers (SERVE_MESH_L now) 8.838e-3
# and 0.947, the int8 tree 1.053e-2 and 1.325.
SERVE_TP_REL = 0.1


def _down_g_dropped(real):
    def row_proj(h, lp, name, dot=None, lora_scale=1.0, tp=None):
        if name != "down" or tp is None:
            return real(h, lp, name, dot, lora_scale, tp)
        from tpu_engine_torch.models.transformer import _proj

        return _proj(h, lp["down.kernel"], None, None, lora_scale, dot)

    return row_proj


def _int8_scale_twice(real):
    def row_proj(h, lp, name, dot=None, lora_scale=1.0, tp=None):
        out = real(h, lp, name, dot, lora_scale, tp)
        from tpu_engine_torch.quant import QuantWeight, mul_round

        w = lp[f"{name}.kernel"]
        if tp is None or not isinstance(w, QuantWeight):
            return out
        bias = lp.get(f"{name}.bias")
        if bias is not None:
            out = out - bias.to(out.dtype)
        out = mul_round(out, w.scale, out.dtype)  # the scale again, after the sum
        return out if bias is None else out + bias.to(out.dtype)

    return row_proj


def mesh_fault(name: str):
    """The patch of the planted serving mesh fault ``name`` (for
    :func:`_patched`)."""
    from tpu_engine_torch.models import transformer as tfm

    return {"down_g_dropped": (tfm, "_row_proj", _down_g_dropped),
            "int8_scale_twice": (tfm, "_row_proj", _int8_scale_twice)}[name]


def main_mesh(card: str) -> dict:
    """The mesh readings (module docstring): each a two-rank job of
    ``chip_smoke._mesh_serve`` in its "teacher" mode, read on the bf16
    weights and on their weight-only int8 tree."""
    import chip_smoke as cs

    cfg, params = cs._serve_mesh_model({})
    out = {"card": card, "serve_tp_rel": SERVE_TP_REL, "layers": cs.SERVE_MESH_L}
    for name, fault in (("mesh_sound", None), ("mesh_down_g_dropped", "down_g_dropped"),
                        ("mesh_int8_scale_twice", "int8_scale_twice")):
        ranks = cs.mesh_launch([], 2, 0, f"faults_{name}", fault, serve="teacher")
        for tree in ("bf16", "int8"):
            r = out[f"{name}:{tree}"] = cs.serve_mesh_rel(cfg, params, ranks, tree)
            print(f"{name}: teacher-forced decode logits of the {tree} weights on model=2 "
                  f"against one rank, relative {r:.4e} (SERVE_TP_REL {SERVE_TP_REL})",
                  flush=True)
    return out


def _patched(patch):
    """A context with ``patch`` = (module, name, wrap) applied, or none."""
    if patch is None:
        return contextlib.nullcontext()
    module, name, wrap = patch
    return mock.patch.object(module, name, wrap(getattr(module, name)))


def _stored_scale(real, f):
    def quantize(rows):
        codes, scale = real(rows)
        return codes, f(scale)

    return quantize


def _moe_decode(gates):
    """A stand-in for ``generate._moe_mlp_decode`` that combines every
    expert's output with ``gates(probs, k)`` [B, T, E] in place of the
    renormalised top-k gates."""
    def moe(h, lp, cfg, tp=None):
        import torch
        import torch.nn.functional as F

        from tpu_engine_torch.models.transformer import _expert_kernel, _router_probs

        B, T, D = h.shape
        probs = _router_probs(h, lp)
        x = h.reshape(B * T, D)
        gate_w, up_w, down_w = (_expert_kernel(lp, n, h.dtype) for n in ("gate", "up", "down"))
        expert_out = torch.matmul(F.silu(x @ gate_w) * (x @ up_w), down_w)   # [E, BT, D]
        w = gates(probs, cfg.top_k).to(h.dtype).reshape(B * T, 1, -1)
        return torch.bmm(w, expert_out.transpose(0, 1)).reshape(B, T, D)

    return lambda real: moe


def _top1(probs, k):
    top = probs.max(dim=-1, keepdim=True)
    return probs.new_zeros(probs.shape).scatter_(-1, top.indices, top.values)


def _topk_raw(probs, k):
    top = probs.topk(k, dim=-1)
    return probs.new_zeros(probs.shape).scatter_(-1, top.indices, top.values)


def _scale_dropped(real):
    def kernel(lp, name, dtype):
        w = real(lp, name, dtype)
        if name == "down":
            w[0] = lp["down.kernel"].q[0].to(dtype)
        return w

    return kernel


def _reroutes(params, cfg, dtype) -> dict:
    """Decode against forward on one 320-token stream of ``params``: the
    tokens rerouted per layer and the logits' relative error."""
    import torch

    import chip_smoke as cs
    from tpu_engine_torch import generate as tgen
    from tpu_engine_torch.models import transformer as tfm

    toks = torch.randint(1, cfg.vocab_size, (1, 320), device="cuda",
                         generator=torch.Generator(device="cuda").manual_seed(3))
    probs: dict = {"decode": [], "forward": []}
    path = ["decode"]
    real = tfm._router_probs

    def record(h, lp):
        p = real(h, lp)
        probs[path[0]].append(p.detach().reshape(-1, p.shape[-1]))
        return p

    with mock.patch.object(tgen, "_router_probs", record), \
            mock.patch.object(tfm, "_router_probs", record), torch.inference_mode():
        cached = cs._cached_logits(params, cfg, toks, 256, dtype)
        path[0] = "forward"
        fwd = cs._forward_logits(params, cfg.with_(moe_impl="ragged"), toks[:, :-1], dtype)
    L = cfg.n_layers
    # decode: the prefill's L records, then L for each one-token step
    steps = probs["decode"]
    dec = [torch.cat(steps[layer::L]) for layer in range(L)]

    def top(p):
        return p.topk(cfg.top_k, dim=-1).indices.sort(dim=-1).values

    rerouted = [int((top(a) != top(b)).any(dim=-1).sum())
                for a, b in zip(dec, probs["forward"])]
    return {"rerouted_by_layer": rerouted, "logits_rel_err": cs._rel_err(cached, fwd),
            "tokens": toks.shape[1] - 1}


def main_moe(card: str) -> dict:
    """The MoE readings (``--moe``)."""
    import chip_smoke as cs
    from tpu_engine_torch import generate as tgen
    from tpu_engine_torch.models.config import MODEL_CONFIGS

    import torch

    cfg = MODEL_CONFIGS["moe-8x7b"].with_(n_layers=cs.SERVE_MOE_L)
    params = cs._moe_int8_tree(cfg)
    plan = cs._serve_moe_plan(cfg)
    out: dict = {"card": card, "tau": cs.SERVE_MOE_TAU, "fp32_bound": cs.SERVE_MOE_FP32,
                 "stream_gap": {}, "reroutes": {}}
    torch.backends.cuda.matmul.allow_tf32 = False
    for name, dtype in (("bf16", torch.bfloat16), ("fp32", torch.float32)):
        r = out["reroutes"][name] = _reroutes(params, cfg, dtype)
        print(f"moe reroutes ({name}): decode against forward on {r['tokens']} tokens, "
              f"logits relative {r['logits_rel_err']:.3e}, tokens rerouted by layer "
              f"{r['rerouted_by_layer']}", flush=True)
    faults = {
        "moe_sound": None,
        "moe_top1": (tgen, "_moe_mlp_decode", _moe_decode(_top1)),
        "moe_no_renorm": (tgen, "_moe_mlp_decode", _moe_decode(_topk_raw)),
        "int8_scale_dropped": (tgen, "_expert_kernel", _scale_dropped),
    }
    sound = None
    for name, patch in faults.items():
        with _patched(patch):
            tokens, _ = cs._streams(params, cfg, plan, **cs.SERVE_MOE_CFG)
            fp32 = cs._moe_fp32_check(params, cfg, plan)
        sound = sound or tokens
        row = out["stream_gap"][name] = {
            "bf16": cs._moe_gaps(params, cfg, plan, tokens, torch.bfloat16), "fp32": fp32,
            "tokens_equal_to_sound": sum(a == b for t, u in zip(tokens, sound)
                                         for a, b in zip(t, u))}
        b = row["bf16"]
        print(f"moe {name}: bf16 gaps median {b['median']:.4f} (tau {cs.SERVE_MOE_TAU}), p90 "
              f"{b['p90']:.4f}, p99 {b['p99']:.4f}, max {b['max']:.4f}, "
              f"{b['share_within']:.4f} within {cs.SERVE_MOE_FP32['gap']}; fp32 "
              f"{fp32['share_within']:.4f} within {cs.SERVE_MOE_FP32['gap']} (bound "
              f"{cs.SERVE_MOE_FP32['share']}), median {fp32['median']:.4f}, max "
              f"{fp32['max']:.4f}; {row['tokens_equal_to_sound']} of "
              f"{sum(len(t) for t in tokens)} bf16 tokens equal to the sound run's", flush=True)
    return out


def main() -> int:
    moe = "--moe" in sys.argv[1:]
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("serve_faults: no CUDA device; this script runs only on the card", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from tpu_engine_torch import generate as tgen
    from tpu_engine_torch import serving as tsrv

    card = cs._card_line()
    print(card, flush=True)
    if moe:
        out = main_moe(card)
        print(json.dumps(out), flush=True)
        (ROOT / "chiprun_out").mkdir(exist_ok=True)
        (ROOT / "chiprun_out" / "serve_faults_moe.json").write_text(json.dumps(out, indent=1))
        return 0
    if "--mesh" in sys.argv[1:]:
        out = main_mesh(card)
        print(json.dumps(out), flush=True)
        (ROOT / "chiprun_out").mkdir(exist_ok=True)
        (ROOT / "chiprun_out" / "serve_faults_mesh.json").write_text(json.dumps(out, indent=1))
        return 0
    state: dict = {}
    cfg, params = cs._llama_1b(state)
    plan = cs._serve_plan(cfg)
    greedy = [i for i, (_, _, t) in enumerate(plan) if t == 0.0]
    out: dict = {"card": card, "tau": cs.SERVE_TAU, "int8_share": cs.INT8_SHARE,
                 "spec_accept_min": cs.SPEC_ACCEPT_MIN, "stream_gap": {}, "int8": {},
                 "spec": {}}

    stream_faults = {
        "sound": (False, None),
        "sound_int8": (True, None),
        "second_best": (False, (tsrv, "_pick_tokens", _second_best)),
        "rope_plus_one": (False, (tsrv, "_run_layers", _rope_plus_one)),
    }
    sound_tokens = None
    for name, (kv_quant, patch) in stream_faults.items():
        with _patched(patch):
            tokens, _ = cs._streams(params, cfg, plan, kv_quant=kv_quant)
        sound_tokens = sound_tokens or tokens
        gaps = [cs._stream_gap(params, cfg, plan[i][0], tokens[i]) for i in greedy]
        out["stream_gap"][name] = {"max": max(gaps), "per_request": gaps,
                                   "tokens_equal_to_sound": sum(
                                       a == b for i in greedy
                                       for a, b in zip(tokens[i], sound_tokens[i]))}
        print(f"stream {name}: largest teacher-forced gap {max(gaps):.4f} (tau {cs.SERVE_TAU}), "
              f"{out['stream_gap'][name]['tokens_equal_to_sound']} greedy tokens equal to "
              "the sound bf16 run's", flush=True)

    spec_plan = cs._spec_plan(cfg)
    drafts = {"own_draft": (params, cfg), "draft_2l": cs._draft_2l(state)[::-1]}
    spec_faults = {
        "spec_sound": None,
        "spec_rewind_keeps_one": (tsrv, "_rewind", _rewind_keeps_one),
        "spec_draft_gamma_steps": (tsrv, "_draft_propose", _draft_gamma_steps),
    }
    spec_sound = {}
    for name, patch in spec_faults.items():
        for dkey, (dparams, dcfg) in drafts.items():
            with _patched(patch):
                tokens, stats = cs._streams(params, cfg, spec_plan, draft_params=dparams,
                                            draft_cfg=dcfg, **cs.SPEC_CFG)
                frontier = cs.spec_frontier(params, cfg, dparams, dcfg,
                                            [p for p, _, _ in spec_plan[:8]])
            spec_sound.setdefault(dkey, tokens)
            gaps = [cs._stream_gap(params, cfg, p, toks)
                    for (p, _, _), toks in zip(spec_plan, tokens)]
            row = out["spec"].setdefault(name, {})[dkey] = {
                "max_gap": max(gaps), "per_request": gaps,
                "accepted_per_round": stats["spec_tokens_accepted"] / stats["spec_rounds"],
                "rounds": stats["spec_rounds"], "frontier": frontier,
                "tokens_equal_to_sound": sum(a == b for t, s in zip(tokens, spec_sound[dkey])
                                             for a, b in zip(t, s))}
            print(f"spec {name} ({dkey}): {row['accepted_per_round']:.4f} accepted tokens a "
                  f"round (bound {cs.SPEC_ACCEPT_MIN} for own_draft), largest teacher-forced "
                  f"gap {row['max_gap']:.4f} (tau {cs.SERVE_TAU}), {row['tokens_equal_to_sound']}"
                  f" tokens equal to the sound run's; frontier {json.dumps(frontier)}",
                  flush=True)

    prompts = [p for p, _, _ in plan[:8]]
    teacher = torch.tensor([toks[:16] for toks in sound_tokens[:8]], device="cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    int8_faults = {
        "sound": None,
        "scale_bf16": lambda s: s.bfloat16().float(),
        "scale_127_128": lambda s: s * (127 / 128),
        "dequant_skipped": torch.ones_like,
    }
    for kind, dtype in (("bf16", torch.bfloat16), ("fp32", torch.float32)):
        p = params if dtype == torch.bfloat16 else {k: v.float() for k, v in params.items()}
        full = cs._pool_logits(p, cfg, prompts, teacher, False, dtype)
        for name, f in int8_faults.items():
            with (mock.patch.object(tgen, "_quantize_rows", _stored_scale(tgen._quantize_rows, f))
                  if f else contextlib.nullcontext()):
                q = cs._pool_logits(p, cfg, prompts, teacher, True, dtype)
            share = float((q - full).abs().max() / full.abs().max())
            out["int8"].setdefault(name, {})[kind] = share
            print(f"int8 {name} ({kind}): {share:.4e} of max |logit| "
                  f"(bound {cs.INT8_SHARE[kind]})", flush=True)
        del p, full

    print(json.dumps(out), flush=True)
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / "serve_faults.json").write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
