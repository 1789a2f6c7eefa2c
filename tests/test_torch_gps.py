"""The port's MoE-GPS simulator and strategy selection against the JAX
package's (``repro.core.{balance,simulator,gps}``), on the CPU.

The same inputs go through both packages in float64; every latency term,
saving and verdict must agree to ``rtol=1e-12`` (the arithmetic is the
same, in the same order, so in practice it is equal). The hardware points
are the paper's two A100 presets and the port's H100 preset, built on the
JAX side as a ``repro.core.simulator.HardwareConfig`` with the same
numbers. Then port versions of ``tests/test_simulator_gps.py``'s headline
checks.
"""

import dataclasses
import itertools

import numpy as np
import pytest

from repro.configs.registry import get_config as jax_get_config
from repro.core import balance as jbal
from repro.core import gps as jgps
from repro.core import simulator as jsim
from repro_torch.configs.registry import get_config
from repro_torch.core import balance as tbal
from repro_torch.core import gps as tgps
from repro_torch.core import simulator as tsim

RTOL = 1e-12
H100 = tsim.H100_SXM_NVLINK
HW = {  # name: (port preset, JAX preset with the same numbers)
    "a100_nvlink": (tsim.A100_NVLINK, jsim.A100_NVLINK),
    "a100_pcie": (tsim.A100_PCIE, jsim.A100_PCIE),
    "h100": (H100, jsim.HardwareConfig(
        H100.name, H100.num_devices, H100.peak_flops, H100.hbm_bw,
        H100.link_bw, mxu_util=H100.mxu_util)),
}
MIX = get_config("mixtral-8x7b")


def _cfgs(reduced: bool):
    t, j = get_config("mixtral-8x7b"), jax_get_config("mixtral-8x7b")
    return (t.reduced(), j.reduced()) if reduced else (t, j)


def _close(a, b, msg=""):
    np.testing.assert_allclose(a, b, rtol=RTOL, atol=0, err_msg=msg)


# --------------------------------------------------------------------------
# balance
# --------------------------------------------------------------------------

def test_balance_functions_match_jax():
    rng = np.random.default_rng(0)
    for E in (4, 8, 64):
        p = rng.dirichlet(np.ones(E) * 0.5)
        q = rng.dirichlet(np.ones(E))
        assert tbal.skewness(p) == jbal.skewness(p)
        assert tbal.error_rate(p, q) == jbal.error_rate(p, q)
    for eps, n, sc in itertools.product((0.0, 0.05, 0.3), (1, 4, 16),
                                        ("optimistic", "typical",
                                         "pessimistic")):
        assert tbal.bottleneck_factor(eps, n, sc) == \
            jbal.bottleneck_factor(eps, n, sc)
        assert tbal.comm_factor(eps, sc) == jbal.comm_factor(eps, sc)
    assert tbal.comm_factor(-0.1) == jbal.comm_factor(-0.1) == 1.0
    with pytest.raises(ValueError):
        tbal.bottleneck_factor(0.1, 4, "bogus")


# --------------------------------------------------------------------------
# simulator
# --------------------------------------------------------------------------

def test_h100_preset_numbers():
    assert (H100.name, H100.num_devices) == ("4xH100-SXM-NVLink", 4)
    assert (H100.peak_flops, H100.hbm_bw, H100.link_bw, H100.mxu_util) == \
        (989e12, 3.35e12, 900e9, 0.45)
    assert set(tsim.PRESETS) == {"4xA100-NVLink", "4xA100-PCIe",
                                 "4xH100-SXM-NVLink"}
    for name in ("4xA100-NVLink", "4xA100-PCIe"):
        assert dataclasses.asdict(tsim.PRESETS[name]) == \
            dataclasses.asdict(jsim.PRESETS[name])


@pytest.mark.parametrize("reduced", [False, True])
def test_workload_terms_match_jax(reduced):
    t, j = _cfgs(reduced)
    assert tsim.ffn_flops_per_token(t) == jsim.ffn_flops_per_token(j)
    assert tsim.dense_ffn_flops_per_token(t) == \
        jsim.dense_ffn_flops_per_token(j)
    assert tsim.expert_bytes(t) == jsim.expert_bytes(j)
    for tokens, seq, causal in itertools.product((1, 512, 8192),
                                                 (1, 256, 4096, 32768),
                                                 (True, False)):
        assert tsim.attention_flops(t, tokens, seq, causal) == \
            jsim.attention_flops(j, tokens, seq, causal)
    # the always-on branches the port's configs do not use yet
    for kw in (dict(num_shared_experts=2), dict(dense_residual=True),
               dict(dense_residual=True, d_ff_dense=512)):
        tt = dataclasses.replace(t, moe=dataclasses.replace(t.moe, **kw))
        jj = dataclasses.replace(j, moe=dataclasses.replace(j.moe, **kw))
        assert tsim.dense_ffn_flops_per_token(tt) == \
            jsim.dense_ffn_flops_per_token(jj) > 0


def test_attention_flops_refuses_mla():
    with pytest.raises(NotImplementedError):
        tsim.attention_flops(dataclasses.replace(MIX, attention="mla"), 8,
                             64)


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("hw", sorted(HW))
def test_layer_latency_grid_matches_jax(hw, reduced):
    t, j = _cfgs(reduced)
    th, jh = HW[hw]
    n = 0
    for skew, strategy, scenario, comm, lever in itertools.product(
            (1.0, 1.4, 2.0, 3.0, 4.0),
            ("none", "dist_only", "token_to_expert"),
            ("optimistic", "typical", "pessimistic"),
            ("paper", "balanced"),
            ("duplicate", "reschedule", "both")):
        kw = dict(batch=8, seq=256, skew=skew, strategy=strategy, eps=0.07,
                  overhead_frac=0.12, scenario=scenario, comm_model=comm,
                  lever=lever, resched_residual=0.04,
                  resched_extra_frac=0.1, dup_hbm_bytes=3e8)
        a = tsim.layer_latency(t, th, **kw).as_dict()
        b = jsim.layer_latency(j, jh, **kw).as_dict()
        assert a.keys() == b.keys()
        for k in a:
            _close(a[k], b[k], f"{k} {kw}")
        n += 1
    assert n == 270
    for batch, seq in ((16, 2048), (64, 2048), (1, 512)):
        assert tsim.duplication_is_hideable(t, th, batch=batch, seq=seq) == \
            jsim.duplication_is_hideable(j, jh, batch=batch, seq=seq)
    assert tsim.duplication_move_time(t, th, 3) == \
        jsim.duplication_move_time(j, jh, 3)


# --------------------------------------------------------------------------
# MoE-GPS
# --------------------------------------------------------------------------

def _report_numbers(r):
    """(labels, floats) of a report: every result's accuracy and latency
    terms, every saving, and the summary rows' numbers."""
    labels, nums = [r.model, r.hardware, r.skew, r.comm_model,
                    r.best.strategy, r.best_combo.strategy,
                    r.best_combo.lever, r.guideline()], []
    for x in [r.baseline, r.dist_only] + r.t2e_points + r.combos:
        labels += [x.strategy, x.predictor, x.lever]
        nums += [x.accuracy, x.total] + list(x.latency.as_dict().values())
    nums += [r.dist_only_saving, r.t2e_saving, r.saving_difference,
             r.reschedule_saving, r.dist_only_speedup_over_t2e]
    for row in r.summary_rows():
        labels += [k for k in row] + [v for v in row.values()
                                      if isinstance(v, str)]
        nums += [v for v in row.values() if not isinstance(v, str)]
    return labels, np.asarray(nums, np.float64)


def _assert_reports_equal(a, b):
    (la, na), (lb, nb) = _report_numbers(a), _report_numbers(b)
    assert la == lb
    _close(na, nb)


@pytest.mark.parametrize("hw", sorted(HW))
def test_run_gps_matches_jax(hw):
    th, jh = HW[hw]
    t, j = _cfgs(False)
    for skew, kw in itertools.product(
            (1.0, 1.39, 1.7, 2.5, 3.5),
            (dict(),
             dict(levers=("duplicate", "reschedule", "both"),
                  migration_stall_s=2e-5, migration_hidden_frac=0.6,
                  dup_hbm_bytes=1e9, comm_model="balanced"),
             dict(scenario="pessimistic", batch=4, seq=1024,
                  migration_stall_s=1e-3))):
        _assert_reports_equal(tgps.run_gps(t, th, skew=skew, **kw),
                              jgps.run_gps(j, jh, skew=skew, **kw))


@pytest.mark.parametrize("hw", sorted(HW))
@pytest.mark.parametrize("allow_t2e", [True, False])
def test_recommend_strategy_matches_jax(hw, allow_t2e):
    th, jh = HW[hw]
    t, j = _cfgs(False)
    verdicts = set()
    for skew, kw in itertools.product(
            (0.8, 1.0, 1.03, 1.2, 1.6, 2.0, 3.0, 4.0),
            (dict(),
             dict(min_saving=0.3),
             dict(migration_stall_s=5e-4),
             dict(migration_stall_s=5e-4, migration_hidden_frac=0.9),
             dict(levers=("duplicate", "reschedule", "both"),
                  resched_residual=0.02, resched_extra_frac=0.3),
             dict(levers=("reschedule",), migration_stall_s=1e-2))):
        va, ra = tgps.recommend_strategy(t, th, skew=skew,
                                         allow_t2e=allow_t2e, **kw)
        vb, rb = jgps.recommend_strategy(j, jh, skew=skew,
                                         allow_t2e=allow_t2e, **kw)
        assert (str(va), va.lever, va.combined) == \
            (str(vb), vb.lever, vb.combined), (skew, kw)
        assert isinstance(va, str) and va == str(vb)
        _assert_reports_equal(ra, rb)
        verdicts.add(va.combined)
    # the grid reaches more than one verdict
    assert "none" in verdicts and len(verdicts) >= 2


def test_sweep_fit_and_table1_match_jax():
    t, j = _cfgs(False)
    hws = [HW[k] for k in sorted(HW)]
    a = tgps.sweep(t, [h[0] for h in hws], [1.4, 2.0, 3.0])
    b = jgps.sweep(j, [h[1] for h in hws], [1.4, 2.0, 3.0])
    assert len(a) == len(b) == 9
    for x, y in zip(a, b):
        _assert_reports_equal(x, y)
    for skew in (0.5, 1.0, 1.39, 1.395, 1.4, 1.7, 1.99, 2.5):
        assert tgps.default_dist_eps(skew) == jgps.default_dist_eps(skew)
        ca, cb = tgps.default_t2e_curve(skew), jgps.default_t2e_curve(skew)
        assert [dataclasses.astuple(p) for p in ca] == \
            [dataclasses.astuple(p) for p in cb]
    for pts in ([(0.5, 0.01), (0.7, 0.05), (0.9, 0.25)],
                [(0.3, 0.0), (0.6, 0.02)],
                [(0.4, 0.1)]):
        fa = tgps.fit_overhead_curve([tgps.T2EPoint("p", a, o)
                                      for a, o in pts])
        fb = jgps.fit_overhead_curve([jgps.T2EPoint("p", a, o)
                                      for a, o in pts])
        for acc in (0.2, 0.5, 0.8, 0.99):
            _close(fa(acc), fb(acc))


def test_run_gps_refuses_a_model_without_moe():
    for run, cfg in ((tgps.run_gps, get_config("recurrentgemma-2b")),
                     (jgps.run_gps, jax_get_config("recurrentgemma-2b"))):
        with pytest.raises(ValueError):
            run(cfg, tsim.A100_NVLINK if run is tgps.run_gps
                else jsim.A100_NVLINK)


def test_unknown_lever_refused():
    with pytest.raises(ValueError):
        tgps.run_gps(MIX, H100, levers=("teleport",))


def test_strategy_verdict_is_a_string():
    v = tgps.StrategyVerdict("dist_only", "reschedule")
    assert v == "dist_only" and v.prediction == "dist_only"
    assert v.lever == "reschedule" and v.combined == "dist_only+reschedule"
    n = tgps.StrategyVerdict("none", "both")
    assert n.lever == "none" and n.combined == "none"


# --------------------------------------------------------------------------
# headline checks of tests/test_simulator_gps.py, on the port
# --------------------------------------------------------------------------

def test_headline_23_percent_mixtral_mmlu_nvlink():
    """Distribution-Only beats the best Token-to-Expert point by more than
    23% on Mixtral 8x7B at MMLU skewness (1.4) on NVLink."""
    rep = tgps.run_gps(MIX, tsim.A100_NVLINK, batch=1, seq=512, skew=1.4)
    assert rep.best is rep.dist_only
    assert rep.dist_only_speedup_over_t2e > 0.23


def test_u_shape_in_t2e_accuracy():
    """Fig 4: with rising accuracy, latency first falls then rises."""
    curve = [tgps.T2EPoint(f"p{i}", a, 0.002 * np.exp(6 * a))
             for i, a in enumerate(np.linspace(0.3, 0.99, 12))]
    rep = tgps.run_gps(MIX, tsim.A100_PCIE, skew=2.0, t2e_curve=curve)
    tot = [r.total for r in rep.t2e_points]
    best = int(np.argmin(tot))
    assert 0 < best < len(tot) - 1


def test_h100_preset_verdicts_split_at_the_controller_threshold():
    """On the H100 preset without Token-to-Expert, ``min_saving`` 0.45 (the
    card's GPS run) runs plain EP over the flat windows' skews and
    Distribution-Only over the hot windows'."""
    for skew, want in ((1.2, "none"), (1.5, "none"), (1.86, "none"),
                       (2.54, "dist_only"), (3.74, "dist_only")):
        v, _ = tgps.recommend_strategy(MIX, H100, skew=skew,
                                       allow_t2e=False, min_saving=0.45)
        assert v == want, skew
