"""Zero-bubble pipeline schedule, one rank a stage (port of
``tpu_engine/parallel/pipeline_zb.py``).

A stage's backward factors into two halves (Qi et al., ZB-H1): **B**, the
input cotangent the previous stage waits for, and **W**, the weight
gradient nobody waits for. The schedule is 1F1B's until the last
microbatch leaves the last stage; then the drain runs the B half alone
(``torch.autograd.grad`` of the stage's outputs with respect to its input
only: no weight-gradient product runs), stashing the output cotangent, and
the W-tail retires the deferred weight gradients (at most ``P-1-p`` on
stage p) by recomputing the stage from its input, still in the ring, with
respect to the weights only.

:func:`zb_op_table` and :func:`schedule_account` are JAX's, copied as they
are (pure Python): the table is the ground truth of the ticks, and the
account is JAX's analytic F-unit cost of its masked-SPMD lanes, reported
beside the port's runs. The port runs no masked lane: on a rank of its own
a stage idles through its bubble ticks instead of burning them.

Schedule indices (P stages, M microbatches, tick t, K = 2(P-1)+1):
  forward:   stage p computes fm = t - p             (0 <= fm < M)
  backward:  stage p computes bm = t - 2(P-1) + p     (0 <= bm < M);
             combined (BW) iff t <= M+P-2, else the drain's B alone
  W-tail:    tail tick u retires bm = M-(P-1)+u+p on stage p; its input is
             still at ring slot bm % K (no forward has written the ring
             since tick M+P-2)
"""

from __future__ import annotations

from typing import Any

from tpu_engine_torch.parallel.pipeline import Stage, StageWork, run_table

# Per-op lane costs in F-units (forward = 1). The combined backward
# recomputes the stage forward (remat), runs the input-cotangent chain and
# the weight-gradient einsums: 3. B-only drops the weight einsums: 2.
# W-only still pays remat + the intra-stage cotangent chain (inner layers'
# weight grads need the cotangent at their output): 3.
OP_COST = {"F": 1.0, "BW": 3.0, "B": 2.0, "W": 3.0}


def zb_op_table(n_stages: int, microbatches: int) -> list[list[tuple[str, ...]]]:
    """Host-side per-tick op table: ``table[t][p]`` is the tuple of ops
    stage ``p``'s lanes perform at tick ``t`` — drawn from ``"F"``,
    ``"BW"`` (combined backward), ``"B"`` (input-cotangent only) and
    ``"W"`` (deferred weight gradient); ``()`` is an idle (masked) lane.

    This is the ground truth the four scan phases are segmented by, and
    what the schedule tests audit (per-stage op counts, stash bound).
    """
    P_, M = n_stages, microbatches
    ticks = M + 3 * (P_ - 1)
    table: list[list[tuple[str, ...]]] = []
    for t in range(ticks):
        row: list[tuple[str, ...]] = []
        for p in range(P_):
            ops: list[str] = []
            if 0 <= t - p < M:
                ops.append("F")
            bm = t - 2 * (P_ - 1) + p
            if 0 <= bm < M:
                if t <= M + P_ - 2:
                    ops.append("BW")          # steady: combined backward
                elif t <= M + 2 * (P_ - 1) - 1:
                    ops.append("B")           # drain: W deferred
            if t >= M + 2 * (P_ - 1):
                u = t - (M + 2 * (P_ - 1))
                wm = M - (P_ - 1) + u + p
                if u + p <= P_ - 2 and wm >= 0:
                    ops.append("W")           # tail: retire the stash
            row.append(tuple(ops))
        table.append(row)
    return table


def _phase_ticks(schedule: str, n_stages: int, microbatches: int) -> dict[str, int]:
    P_, M = n_stages, microbatches
    if schedule == "gpipe":
        # GPipe-by-autodiff: a forward scan of M+P-1 ticks, then autodiff
        # replays the reverse pipeline over the same tick count.
        return {"forward": M + P_ - 1, "backward": M + P_ - 1}
    if schedule == "1f1b":
        return {"steady": M + 2 * (P_ - 1)}
    if schedule == "zb":
        return {
            "warmup": P_ - 1,
            "steady": M,
            "drain": P_ - 1,
            "tail": P_ - 1,
        }
    raise ValueError(f"unknown pipeline schedule {schedule!r}")


# Per-tick cost of one lane in each phase, in F-units. Every lane of a
# masked-SPMD tick executes the phase's full program whether masked or not
# — that is precisely what makes bubble lanes expensive.
_PHASE_LANE_COST = {
    "forward": OP_COST["F"],
    "backward": OP_COST["BW"],
    "steady": OP_COST["F"] + OP_COST["BW"],
    "warmup": OP_COST["F"],
    "drain": OP_COST["B"],
    "tail": OP_COST["W"],
}


def schedule_account(
    schedule: str, n_stages: int, microbatches: int
) -> dict[str, Any]:
    """Analytic tick / busy-lane account for one schedule.

    Costs are per-stage lane F-units (forward of one microbatch through
    one stage = 1). ``useful`` is the work the objective requires — one F
    and one combined backward per (microbatch, stage), 4M per stage
    regardless of schedule; everything else a lane executes (masked bubble
    compute, split-backward remat duplication) is ``burned``. The busy
    fraction is what divides raw MFU into bubble-adjusted MFU
    (``tpu_engine/profiler.py``).
    """
    P_, M = n_stages, microbatches
    if P_ < 2:
        return {
            "schedule": schedule, "n_stages": P_, "microbatches": M,
            "ticks": 0, "lane_cost": 0.0, "useful_cost": 0.0,
            "burned_cost": 0.0, "busy_fraction": 1.0, "bubble_fraction": 0.0,
            "phases": {},
        }
    phases = _phase_ticks(schedule, P_, M)
    lane_cost = sum(_PHASE_LANE_COST[ph] * n for ph, n in phases.items())
    useful = 4.0 * M
    burned = lane_cost - useful
    ticks = sum(phases.values())
    return {
        "schedule": schedule,
        "n_stages": P_,
        "microbatches": M,
        "ticks": ticks,
        "lane_cost": lane_cost,
        "useful_cost": useful,
        "burned_cost": burned,
        "busy_fraction": useful / lane_cost if lane_cost else 1.0,
        "bubble_fraction": burned / lane_cost if lane_cost else 0.0,
        "phases": phases,
    }


def zb_table(n_stages: int, microbatches: int) -> list:
    """:func:`zb_op_table` with each op's microbatch: ``table[t][p]``
    lists stage p's ``(op, microbatch)`` at tick t."""
    P, M = n_stages, microbatches
    out = []
    for t, row in enumerate(zb_op_table(P, M)):
        ticks = []
        for p, ops in enumerate(row):
            mb = {"F": t - p, "BW": t - 2 * (P - 1) + p, "B": t - 2 * (P - 1) + p,
                  "W": M - (P - 1) + (t - (M + 2 * (P - 1))) + p}
            ticks.append([(op, mb[op]) for op in ops])
        out.append(ticks)
    return out


def pipeline_zb_grads(stage: Stage, work: StageWork):
    """Run the zero-bubble schedule on this stage; the contract of
    ``pipeline_1f1b_grads`` (a reordering of the same per-stage backward
    halves: losses and gradients match 1F1B's and GPipe's)."""
    return run_table(zb_table(stage.n, work.M), stage, work, keep_graph=False)
