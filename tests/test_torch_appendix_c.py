"""The paper's Appendix C sweep on the port's ``core.gps.run_gps`` against
the JAX package's, on the CPU.

``benchmarks/bench_appendix_c.py`` runs ``run_gps`` (batch 1, 512
tokens) for each paper model on the A100 NVLink and A100 PCIe presets at
skews 1.4, 2.0 and 3.0, and reads the winner (Distribution-Only or
Token-to-Expert) and the saving difference. The same grid, for the
bench's three models and Arctic (the dense residual branch's FLOPs and
bytes enter the layer model), gives the same winners and saving
differences within 1e-9 in both packages, and so the same trend verdict.
"""

import pytest

from benchmarks import bench_appendix_c as bench
from repro.configs.registry import get_config as jax_get_config
from repro.core import gps as jgps
from repro.core import simulator as jsim
from repro_torch.configs.registry import get_config
from repro_torch.core import gps as tgps
from repro_torch.core import simulator as tsim

MODELS = bench.MODELS + ("arctic-480b",)
HW = {"a100_nvlink": (tsim.A100_NVLINK, jsim.A100_NVLINK),
      "a100_pcie": (tsim.A100_PCIE, jsim.A100_PCIE)}


def _winner(rep):
    return "DIST" if rep.best is rep.dist_only else "T2E"


@pytest.mark.parametrize("hw", list(HW))
@pytest.mark.parametrize("model", MODELS)
def test_appendix_c_sweep_matches_jax(model, hw):
    t_hw, j_hw = HW[hw]
    assert t_hw.name == j_hw.name
    for skew in bench.SKEWS:
        got = tgps.run_gps(get_config(model), t_hw, batch=1, seq=512,
                           skew=skew)
        want = jgps.run_gps(jax_get_config(model), j_hw, batch=1, seq=512,
                            skew=skew)
        assert _winner(got) == _winner(want), skew
        assert got.saving_difference == pytest.approx(
            want.saving_difference, abs=1e-9), skew
        assert (got.best.strategy, got.best.predictor) == (
            want.best.strategy, want.best.predictor), skew
        assert got.best.total == pytest.approx(want.best.total, rel=1e-9)


def test_appendix_c_rows_equal_the_benchmarks():
    """The bench's own rows (winner, saving difference rounded to 4
    places) from the port's ``run_gps``, and its trend verdict."""
    rows, _ = bench.run(verbose=False)
    got = []
    for name in bench.MODELS:
        for t_hw, _ in HW.values():
            for skew in bench.SKEWS:
                rep = tgps.run_gps(get_config(name), t_hw, batch=1, seq=512,
                                   skew=skew)
                got.append(dict(model=name, hw=t_hw.name, skew=skew,
                                winner=_winner(rep),
                                saving_diff=round(rep.saving_difference, 4)))
    assert got == rows
