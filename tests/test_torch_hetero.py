"""Port parity: the heterogeneity plane (``tpu_engine_torch/hetero.py``)
against JAX's copy through one script of calls — the solver, the
goodput model, the HBM row caps (at the port's own estimate, which equals
JAX's), ``host_health``, the throughput tracker and the hysteresis-guarded
rebalancer on a scripted clock, its audit events included — and the
refusal that stays: a live unequal plan on a mesh meets ``data.py``'s
equal-split rule."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from tpu_engine import hetero as jhet  # noqa: E402
from tpu_engine import tracing as jtracing  # noqa: E402
from tpu_engine.mesh_runtime import MeshConfig  # noqa: E402
from tpu_engine.sharding import TPUTrainConfig  # noqa: E402
from tpu_engine_torch import data as tdata  # noqa: E402
from tpu_engine_torch import hetero as thet  # noqa: E402
from tpu_engine_torch import tracing as ttracing  # noqa: E402
from tpu_engine_torch.mesh_runtime import MeshConfig as TMeshConfig  # noqa: E402
from tpu_engine_torch.train import TrainConfig  # noqa: E402


def _solver_script(mod) -> list:
    rng = np.random.default_rng(3)
    out = [mod.uniform_assignment(10, 4), mod.solve_row_assignment([1.0] * 4, 16),
           mod.solve_row_assignment([1.0, 1.0, 1.0, 0.5], 16),
           mod.solve_row_assignment([1.0, 0.0], 8),
           mod.predicted_goodput([4, 4], [1.0, 0.5]), mod.predicted_goodput([], [])]
    for _ in range(40):
        n = int(rng.integers(1, 7))
        tput = [float(x) for x in rng.uniform(0.05, 2.0, n)]
        total = int(rng.integers(n, 64))
        caps = [int(c) for c in rng.integers(total // n, total + 1, n)]
        try:
            out.append(mod.solve_row_assignment(tput, total, min_rows=1, max_rows=caps))
        except mod.InfeasibleAssignment as e:
            out.append(str(e))
    for args in (([1.0, 1.0], 1, 1, None), ([1.0, 1.0], 8, 2, [1, 8]), ([1.0, 1.0], 8, 0, [3, 3]),
                 ([], 8, 0, None)):
        try:
            mod.solve_row_assignment(args[0], args[1], min_rows=args[2], max_rows=args[3])
        except ValueError as e:  # InfeasibleAssignment is one
            out.append((type(e).__name__, str(e)))
    out.append(mod.host_health(3, [1.2, 0.5, 0.9], quarantined_devices=[5],
                               devices_per_host=4, fault_counts={0: 1, 2: 3}))
    return out


def test_solver_goodput_and_health_match_jax():
    assert _solver_script(thet) == _solver_script(jhet)


@pytest.mark.parametrize("budget", [2.0, 6.0, 30.0, 200.0])
def test_hbm_row_caps_match_jax(budget):
    """The caps from each package's own ``estimate_job_hbm`` (equal, by
    tests/test_torch_device_plane.py) on the same config."""
    kw = dict(model_name="llama-1b", seq_len=2048, micro_batch_size=2)
    jfn = jhet.hbm_max_rows_fn(TPUTrainConfig(mesh=MeshConfig(data=4), **kw), 4, budget)
    tfn = thet.hbm_max_rows_fn(TrainConfig(mesh=TMeshConfig(data=4), **kw), 4, budget)
    for p, rows_u in ((0, 2), (1, 4), (3, 1)):
        assert tfn(p, rows_u) == jfn(p, rows_u)


def _tracker_script(mod) -> list:
    trk = mod.ThroughputTracker(3, alpha=0.25, decay=0.02)
    out = [trk.relative_throughput(), trk.imbalance()]
    for i in range(12):
        trk.observe_step(0.1 + 0.01 * (i % 3))
        if i % 4 == 0:
            trk.note_host_slow(2, 0.3, 0.1)
    out += [trk.relative_throughput(), trk.imbalance(), trk.baseline_s()]
    trk.note_attribution("host-slow", {"sustained": True, "duration_s": 0.4,
                                       "baseline_s": 0.1}, 1)
    trk.note_attribution("checkpoint_save", {"sustained": True, "duration_s": 0.4,
                                             "baseline_s": 0.1}, 0)
    trk.note_host_slow(None, 0.2, 0.1)
    trk.note_host_slow(99, 0.2, 0.1)
    out += [trk.relative_throughput(), trk.stats()]
    for _ in range(100):
        trk.observe_step(0.1)
    out.append(trk.relative_throughput())
    return out


def test_tracker_matches_jax():
    assert _tracker_script(thet) == _tracker_script(jhet)


def _rebalancer_script(mod, tracing_mod) -> list:
    t = [0.0]
    rec = tracing_mod.FlightRecorder(clock=lambda: t[0])

    def slow_tracker():
        trk = mod.ThroughputTracker(2)
        for _ in range(30):
            trk.note_host_slow(1, 1.0, 1.0)
        return trk

    out = []
    reb = mod.HeteroRebalancer(slow_tracker(), 8, sustain_consults=2, min_gain=0.01,
                               cooldown_s=60.0, dry_run=True, clock=lambda: t[0],
                               recorder=rec, trace_id="t-hetero")
    out.append(reb.maybe_rebalance(10))
    t[0] = 5.0
    plan = reb.maybe_rebalance(20)
    out += [plan.describe(), reb.assignment, reb.stats()]
    live = mod.HeteroRebalancer(slow_tracker(), 8, sustain_consults=1, min_gain=0.01,
                                dry_run=False, cooldown_steps=3, clock=lambda: t[0],
                                recorder=rec)
    plan = live.maybe_rebalance(30)
    out += [plan.describe(), live.assignment, live.maybe_rebalance(31), live.skips]
    live.revert(plan)
    out += [live.assignment, live.recovered_goodput_fraction()]
    live.request_consult()
    out += [live.consult_pending(), live.consult_pending()]
    capped = mod.HeteroRebalancer(slow_tracker(), 8, sustain_consults=1, min_gain=0.01,
                                  dry_run=False, clock=lambda: t[0], recorder=rec,
                                  max_rows_fn=lambda p, u: 5)
    out.append(capped.maybe_rebalance(40).describe())
    gain = mod.HeteroRebalancer(slow_tracker(), 8, sustain_consults=1, min_gain=0.9,
                                clock=lambda: t[0], recorder=rec)
    out += [gain.maybe_rebalance(50), gain.skips]
    balanced = mod.HeteroRebalancer(mod.ThroughputTracker(4), 16, sustain_consults=1,
                                    clock=lambda: t[0], recorder=rec)
    out += [[balanced.maybe_rebalance(s) for s in range(3)], balanced.skips]
    out.append([(e["name"], e["trace_id"], e["attrs"]) for e in rec.events(kind="hetero")])
    mod.set_active(live)
    out.append(mod.get_active() is live)
    mod.clear_active()
    out.append(mod.get_active())
    return [_plain(x) for x in out]


def _plain(x):
    """A result without wall-clock fields."""
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items() if k not in ("ts", "last_rebalance_ts")}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    return x


def test_rebalancer_matches_jax():
    assert _rebalancer_script(thet, ttracing) == _rebalancer_script(jhet, jtracing)


def test_broadcast_agree_is_identity_in_one_process():
    assert thet.broadcast_agree_fn()([1.0, 0.5]) == [1.0, 0.5]


def test_live_unequal_plan_on_a_mesh_meets_the_equal_split_rule(tmp_path):
    """A live plan's unequal rows on a mesh of two row ranks raise JAX's
    ``ValueError`` (not the sharding's per-process partition); the equal
    split passes; one process takes any plan."""
    path = tdata.write_token_file(np.arange(64 * 33, dtype=np.uint16) % 500,
                                  str(tmp_path / "tok.bin"))
    ds = tdata.TokenFileDataset(path, seq_len=32)

    class Program:
        device = torch.device("cpu")
        runtime = None

        @staticmethod
        def global_batch_shape():
            return (1, 4, 32)

    reb = thet.HeteroRebalancer(thet.ThroughputTracker(2), 4, sustain_consults=1,
                                min_gain=0.01, dry_run=False)
    for _ in range(30):
        reb.tracker.note_host_slow(1, 1.0, 1.0)
    plan = reb.maybe_rebalance(1)
    assert plan is not None and plan.assignment != [2, 2]
    fn = tdata.make_data_fn(Program, ds, process_count=2, process_index=0)
    try:
        with pytest.raises(ValueError, match="per-process batch partition"):
            fn.reassign(plan.assignment)
        assert fn.reassign([2, 2]) == [2, 2]
    finally:
        fn.close()
    one = tdata.make_data_fn(Program, ds, process_count=1, process_index=0)
    try:
        assert one.reassign([4]) == [4]
    finally:
        one.close()
