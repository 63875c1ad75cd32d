"""The 1F1B (one-forward-one-backward) pipeline schedule, one rank a stage
(port of ``tpu_engine/parallel/pipeline_1f1b.py``).

In steady state every stage runs one forward and one backward a tick, and
a microbatch's backward starts as soon as its forward leaves the last
stage, so a stage holds at most ``K = 2(P-1)+1`` stage inputs at a time
(JAX's ring of K slots) whatever the microbatch count M: the schedule's
value is memory (PipeDream-Flush / Megatron-LM). The forward runs without
a graph and keeps only the stage's input; each backward recomputes the
stage from it under the program's remat policy and pulls the cotangent
back (JAX's per-stage ``jax.vjp``). The last stage runs its forward at its
backward's tick, on the same input, so it computes once.

Schedule indices (P stages, M microbatches, tick t), JAX's:

- forward: stage p runs microbatch ``t - p``;
- backward: stage p runs microbatch ``t - 2(P-1) + p``;
- ring: stage p keeps microbatch m's input at slot ``m % K``.

Each tick ends with one trade a neighbour (``pipeline.exchange``: the
boundary activation to the next stage, the input cotangent to the
previous one, posted together).
"""

from __future__ import annotations

from tpu_engine_torch.parallel.pipeline import Stage, StageWork, run_table


def f1b_table(n_stages: int, microbatches: int) -> list:
    """The ticks of 1F1B: ``table[t][p]`` lists stage p's ``(op,
    microbatch)`` at tick t (``F``, then ``BW``), M + 2(P-1) ticks."""
    P, M = n_stages, microbatches
    table = []
    for t in range(M + 2 * (P - 1)):
        row = []
        for p in range(P):
            ops = []
            if 0 <= t - p < M:
                ops.append(("F", t - p))
            bm = t - 2 * (P - 1) + p
            if 0 <= bm < M:
                ops.append(("BW", bm))
            row.append(ops)
        table.append(row)
    return table


def pipeline_1f1b_grads(stage: Stage, work: StageWork):
    """Run 1F1B on this stage; returns (summed loss terms, summed aux
    terms), the parameters' gradients accumulated through autograd."""
    return run_table(f1b_table(stage.n, work.M), stage, work, keep_graph=False)
