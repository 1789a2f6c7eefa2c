"""The port's online GPS controller and audit log against the JAX
package's (``repro.serve.controller``, ``repro.obs.audit``), on the CPU.

Both controllers see one numpy sequence of per-iteration (L, E) expert
histograms, drawn with ``skewed_distribution`` at a skew that moves flat
-> hot -> flat (some iterations without counts), with replica bytes moved
and hidden and, for the levers beyond duplication, overflow and drop
counts and scheduler residuals. Every ``Decision`` field and every audit
record (``dataclasses.asdict``) must be equal, exactly: the arithmetic is
the same, in the same order. The controller alone also arbitrates the
levers and Token-to-Expert, which the port's engine refuses
(``tests/test_torch_gps_serve.py``). Then the three controller cases of
``tests/test_continuous_serve.py`` on the port, and the audit log's bound,
JSONL round trip and ``explain()`` text.
"""

import dataclasses
import functools
import itertools
import json

import numpy as np
import pytest

from repro.configs.registry import get_config as jax_get_config
from repro.core.simulator import HardwareConfig as JaxHardwareConfig
from repro.obs.audit import GPSAuditLog as JaxAuditLog
from repro.obs.audit import GPSAuditRecord as JaxAuditRecord
from repro.serve.controller import ControllerConfig as JaxControllerConfig
from repro.serve.controller import OnlineGPSController as JaxController
from repro_torch.configs.registry import get_config
from repro_torch.core.simulator import A100_PCIE, H100_SXM_NVLINK
from repro_torch.data.synthetic import skewed_distribution
from repro_torch.obs import GPSAuditLog, GPSAuditRecord
from repro_torch.serve import (ControllerConfig, Decision,
                               OnlineGPSController)

FULL = get_config("mixtral-8x7b")
JAX_FULL = jax_get_config("mixtral-8x7b")
LEVER_SETS = {"duplicate": ("duplicate",),
              "all": ("duplicate", "reschedule", "both")}
DECISION_FIELDS = [f.name for f in dataclasses.fields(Decision)
                   if f.name not in ("recommended", "report")]


def _jax_hw(hw):
    return JaxHardwareConfig(hw.name, hw.num_devices, hw.peak_flops,
                             hw.hbm_bw, hw.link_bw, mxu_util=hw.mxu_util)


@functools.lru_cache(maxsize=None)
def _observations(num_experts: int, cap: float, levers: bool, seed: int):
    """(counts or None, now, observe kwargs) per iteration: skew walks
    flat -> hot -> flat over 48 iterations."""
    rng = np.random.default_rng(seed)
    L = FULL.num_layers
    skews = np.concatenate([np.full(14, 1.0), np.linspace(1.2, cap, 8),
                            np.full(14, cap), np.linspace(cap, 1.0, 6),
                            np.full(6, 1.0)])
    obs = []
    for i, skew in enumerate(skews):
        if i % 11 == 5:
            counts = None                    # an iteration without MoE
        else:
            p = skewed_distribution(num_experts, skew, rng)
            counts = rng.multinomial(400, p, size=L).astype(np.float64)
        moved = float(rng.choice([0.0, 0.0, 3.5e8, 2.8e9, 1.1e10]))
        kw = dict(migration_bytes=moved,
                  migration_hidden_bytes=moved * float(rng.uniform(0, 1.3)))
        if levers:
            over = float(rng.integers(0, 60))
            kw.update(overflow_tokens=over,
                      dropped_tokens=float(rng.integers(0, over + 1)),
                      resched_residual=(None if i % 3 else
                                        float(rng.uniform(0.0, 0.2))),
                      resched_absorbed_pred=(None if i % 4 else
                                             float(rng.uniform(0.3, 1.0))))
        obs.append((counts, 0.25 * (i + 1), kw))
    return obs


def _drive(ctl, obs):
    return [ctl.observe(c, now, **kw) for c, now, kw in obs]


def _decision_dict(d):
    if d is None:
        return None
    out = {f: getattr(d, f) for f in DECISION_FIELDS}
    out["recommended"] = (str(d.recommended), d.recommended.lever)
    out["best_total"] = d.report.best.total
    out["dist_only_saving"] = d.report.dist_only_saving
    return out


def _records(ctl):
    # str() turns each StrategyVerdict into the string it compares as
    return [{k: (str(v) if k == "recommended" else v)
             for k, v in dataclasses.asdict(r).items()}
            for r in ctl.audit.records]


@pytest.mark.parametrize("levers", sorted(LEVER_SETS))
@pytest.mark.parametrize("transfer", [False, True])
@pytest.mark.parametrize("predictor", [False, True])
@pytest.mark.parametrize("patience", [1, 2, 3])
@pytest.mark.parametrize("window", [1, 2, 3, 4])
def test_controller_matches_jax(window, patience, predictor, transfer,
                                levers):
    E, cap = (4, 2.0) if transfer else (8, 3.6)
    kw = dict(window_iters=window, patience=patience, min_saving=0.3,
              levers=LEVER_SETS[levers],
              skew_cap_observed=E / 2 if transfer else 0.0,
              skew_cap_target=4.0 if transfer else 0.0)
    hw = H100_SXM_NVLINK if window % 2 else A100_PCIE
    port = OnlineGPSController(FULL, ControllerConfig(hardware=hw, **kw),
                               predictor_available=predictor)
    ref = JaxController(JAX_FULL, JaxControllerConfig(hardware=_jax_hw(hw),
                                                      **kw),
                        predictor_available=predictor)
    obs = _observations(E, cap, levers != "duplicate", seed=patience)
    got, want = _drive(port, obs), _drive(ref, obs)
    assert [_decision_dict(d) for d in got] == \
        [_decision_dict(d) for d in want]
    assert _records(port) == _records(ref)
    assert (port.strategy, port.lever, port.predict_interval,
            port.num_switches) == (ref.strategy, ref.lever,
                                   ref.predict_interval, ref.num_switches)
    assert port.switch_log() == ref.switch_log()
    assert port.audit.summary() == ref.audit.summary()
    assert port.audit.explain() == ref.audit.explain()
    # the sequence exercises the controller: decisions, both verdict
    # kinds, and at least one switch
    assert len(port.decisions) >= 10
    assert {str(d.recommended) for d in port.decisions} >= {"none"}
    assert port.num_switches >= 1


def test_controller_refuses_a_model_without_moe():
    with pytest.raises(ValueError):
        OnlineGPSController(get_config("recurrentgemma-2b"))


def test_controller_defaults_match_jax():
    a, b = ControllerConfig(), JaxControllerConfig()
    for f in dataclasses.fields(a):
        va, vb = getattr(a, f.name), getattr(b, f.name)
        if f.name == "hardware":
            assert dataclasses.asdict(va) == dataclasses.asdict(vb)
            assert va is A100_PCIE
        else:
            assert va == vb, f.name


# --------------------------------------------------------------------------
# tests/test_continuous_serve.py's controller cases, on the port
# --------------------------------------------------------------------------

def _counts_with_skew(L, E, skew, total=1000.0):
    p_max = skew / E
    rest = (1.0 - p_max) / (E - 1)
    p = np.full((E,), rest)
    p[0] = p_max
    return np.tile(p * total, (L, 1))


def test_controller_switches_on_skew_shift():
    ctl = OnlineGPSController(
        FULL, ControllerConfig(window_iters=2, patience=1),
        predictor_available=True, initial_strategy="dist_only")
    L, E = FULL.num_layers, FULL.moe.num_experts
    decisions = []
    t = 0.0
    for skew in (1.5, 1.5, 3.2, 3.2, 3.2, 1.05, 1.05):
        for _ in range(2):
            t += 1.0
            d = ctl.observe(_counts_with_skew(L, E, skew), t)
            if d is not None:
                decisions.append(d)
    strategies = [d.strategy for d in decisions]
    assert "token_to_expert" in strategies          # high-skew window
    assert ctl.num_switches >= 1
    assert decisions[0].skew == pytest.approx(1.5, abs=0.01)


def test_controller_hysteresis_needs_patience():
    ctl = OnlineGPSController(
        FULL, ControllerConfig(window_iters=1, patience=3),
        predictor_available=True, initial_strategy="dist_only")
    L, E = FULL.num_layers, FULL.moe.num_experts
    d1 = ctl.observe(_counts_with_skew(L, E, 3.2), 1.0)
    assert d1.recommended == "token_to_expert" and not d1.switched
    d2 = ctl.observe(_counts_with_skew(L, E, 3.2), 2.0)
    assert not d2.switched
    d3 = ctl.observe(_counts_with_skew(L, E, 3.2), 3.0)
    assert d3.switched and d3.strategy == "token_to_expert"


def test_controller_skew_transfer():
    ctl = OnlineGPSController(
        FULL, ControllerConfig(window_iters=1, patience=1,
                               skew_cap_observed=2.0, skew_cap_target=4.0),
        predictor_available=True)
    # measured 1.9 on a cap-2.0 model ~ concentration 0.9 -> mapped 3.7
    d = ctl.observe(_counts_with_skew(FULL.num_layers, 4, 1.9), 1.0)
    assert d.recommended == "token_to_expert"


# --------------------------------------------------------------------------
# audit log
# --------------------------------------------------------------------------

def _record_kw(i: int, rng) -> dict:
    kw = dict(seq=i, t=0.5 * i, window_iters=8,
              skew_measured=float(rng.uniform(1, 4)),
              skew_input=float(rng.uniform(1, 4)),
              volatility=float(rng.uniform(0, 0.2)),
              migration_bytes=float(rng.uniform(0, 1e10)),
              migration_hidden_bytes=float(rng.uniform(0, 1e9)),
              migration_hidden_frac=float(rng.uniform(0, 1)),
              migration_stall_s=float(rng.uniform(0, 1e-3)),
              batch=8, seq_len=256, allow_t2e=bool(i % 2), min_saving=0.02,
              recommended=("none", "dist_only", "token_to_expert")[i % 3],
              strategy_before="dist_only",
              strategy_after=("none", "dist_only")[i % 2],
              gate=("switched", "pending", "unchanged")[i % 3],
              pending_votes=i % 3, predict_interval=1 + i % 8,
              dist_only_saving=float(rng.uniform(0, 0.6)),
              t2e_saving=float(rng.uniform(0, 0.6)),
              baseline_total_s=float(rng.uniform(1e-4, 1e-3)),
              best_total_s=float(rng.uniform(1e-4, 1e-3)))
    if i % 4 == 1:
        kw.update(lever_recommended="reschedule", lever_after="both",
                  resched_saving=0.12, overflow_pred_frac=0.7,
                  overflow_realized_frac=(-1.0 if i % 8 == 1 else 0.55))
    if i % 5 == 2:
        kw.update(model="m1")
    return kw


def test_audit_explain_and_summary_match_jax():
    rng = np.random.default_rng(3)
    kws = [_record_kw(i, rng) for i in range(12)]
    port, ref = GPSAuditLog(), JaxAuditLog()
    for kw in kws:
        port.append(GPSAuditRecord(**kw))
        ref.append(JaxAuditRecord(**kw))
    assert [dataclasses.asdict(r) for r in port.records] == \
        [dataclasses.asdict(r) for r in ref.records]
    assert port.explain() == ref.explain()
    assert port.explain(last=3) == ref.explain(last=3)
    assert port.summary() == ref.summary()
    assert [r.seq for r in port.switches] == [r.seq for r in ref.switches]
    assert port.to_obj() == ref.to_obj()
    assert [f.name for f in dataclasses.fields(GPSAuditRecord)] == \
        [f.name for f in dataclasses.fields(JaxAuditRecord)]


def test_audit_log_bound_and_model_tag():
    log = GPSAuditLog(maxlen=5, model="m2")
    rng = np.random.default_rng(4)
    for i in range(8):
        log.append(GPSAuditRecord(**_record_kw(i, rng)))
    assert len(log) == 5 and log.dropped == 3
    assert [r.seq for r in log.records] == [3, 4, 5, 6, 7]
    # the log tags untagged records with its model; a record's own tag stays
    assert {r.model for r in log.records} == {"m1", "m2"}
    assert log.records[0].explain().startswith("[m2 3]")


def test_audit_jsonl_roundtrip(tmp_path):
    log = GPSAuditLog()
    rng = np.random.default_rng(5)
    for i in range(6):
        log.append(GPSAuditRecord(**_record_kw(i, rng)))
    path = tmp_path / "audit.jsonl"
    log.to_jsonl(str(path))
    log.to_jsonl(str(path), mode="a")
    rows = [json.loads(line) for line in path.read_text().splitlines()]
    assert len(rows) == 12
    back = [GPSAuditRecord(**r) for r in rows[:6]]
    assert back == log.records
    assert "\n".join(r.explain() for r in back) == log.explain()
    # a pre-lever row (no lever fields) still loads
    old = {k: v for k, v in rows[0].items()
           if k not in ("lever_recommended", "lever_after", "model")}
    assert GPSAuditRecord(**old).lever_recommended == "duplicate"


def test_controller_audit_replays_through_recommend_strategy():
    """Every record holds the inputs of its verdict."""
    from repro_torch.core.gps import recommend_strategy

    ctl = OnlineGPSController(FULL, ControllerConfig(
        hardware=H100_SXM_NVLINK, window_iters=2, patience=1,
        min_saving=0.45))
    for c, now, kw in _observations(8, 3.6, False, seed=7):
        ctl.observe(c, now, **kw)
    assert len(ctl.audit) >= 10 and any(
        r.migration_stall_s > 0 for r in ctl.audit.records)
    for r in ctl.audit.records:
        v, _ = recommend_strategy(
            FULL, H100_SXM_NVLINK, skew=r.skew_input, batch=r.batch,
            seq=r.seq_len, allow_t2e=r.allow_t2e, min_saving=r.min_saving,
            migration_stall_s=r.migration_stall_s,
            resched_residual=r.resched_residual,
            resched_extra_frac=r.resched_extra_frac)
        assert (str(v), v.lever) == (r.recommended, r.lever_recommended)


def test_skewed_distribution_drives_the_window_skew():
    """The sequence's skew is what the controller measures."""
    from repro_torch.serve.metrics import window_skew

    rng = np.random.default_rng(0)
    for E, skew in itertools.product((4, 8), (1.0, 1.5, 2.0)):
        p = skewed_distribution(E, skew, rng)
        assert window_skew(np.tile(p, (3, 1))) == pytest.approx(skew)
