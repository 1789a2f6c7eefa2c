"""The port's analytic roofline (``repro_torch.roofline``) and parameter
counts against the JAX package's, on the CPU.

For each config the port has (Mixtral-8x7B at full width, with one replica
slot per rank, and ``reduced()``; RecurrentGemma-2B) x the four assigned
``INPUT_SHAPES`` x 1 and 4 chips: ``num_params``, ``active_params``,
``analytic_flops``, ``analytic_hbm_bytes`` and ``model_flops`` equal the
JAX functions' to a relative 1e-12. The report's terms use the H100's data
sheet figures (989 TFLOP/s bf16, 3.35 TB/s, 900 GB/s), not the TPU's.
"""

import dataclasses
import json
import math

import pytest

from repro import roofline as jroof
from repro.configs import base as jbase
from repro.configs.registry import get_config as jax_get_config
from repro_torch import roofline as roof
from repro_torch.configs import base
from repro_torch.configs.registry import get_config

REL = 1e-12


def _with_dup(cfg):
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, duplication_slots=1))


CONFIGS = {
    "mixtral": lambda get: get("mixtral-8x7b"),
    "mixtral-dup1": lambda get: _with_dup(get("mixtral-8x7b")),
    "mixtral-reduced": lambda get: get("mixtral-8x7b").reduced(),
    "recurrentgemma": lambda get: get("recurrentgemma-2b"),
}


def _pair(name):
    return CONFIGS[name](get_config), CONFIGS[name](jax_get_config)


def _close(a, b):
    assert math.isclose(a, b, rel_tol=REL, abs_tol=0.0), (a, b)


def test_input_shapes_match_the_jax_package():
    assert set(base.INPUT_SHAPES) == set(jbase.INPUT_SHAPES)
    for name, s in base.INPUT_SHAPES.items():
        assert dataclasses.astuple(s) == dataclasses.astuple(
            jbase.INPUT_SHAPES[name])


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_param_counts_match_the_jax_package(name):
    cfg, jcfg = _pair(name)
    assert cfg.num_params() == jcfg.num_params()
    assert cfg.active_params() == jcfg.active_params()
    if cfg.is_moe:
        assert cfg.active_params() < cfg.num_params()


@pytest.mark.parametrize("chips", [1, 4])
@pytest.mark.parametrize("shape", sorted(base.INPUT_SHAPES))
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_op_model_matches_the_jax_package(name, shape, chips):
    cfg, jcfg = _pair(name)
    s, js = base.INPUT_SHAPES[shape], jbase.INPUT_SHAPES[shape]
    _close(roof.analytic_flops(cfg, s), jroof.analytic_flops(jcfg, js))
    _close(roof.analytic_hbm_bytes(cfg, s, chips),
           jroof.analytic_hbm_bytes(jcfg, js, chips))
    _close(roof.model_flops(cfg, s), jroof.model_flops(jcfg, js))


def test_report_terms_use_the_h100_constants(tmp_path):
    assert (roof.PEAK_FLOPS, roof.HBM_BW, roof.LINK_BW) == (989e12, 3.35e12,
                                                            900e9)
    cfg = get_config("mixtral-8x7b")
    shape = base.INPUT_SHAPES["decode_32k"]
    r = roof.analyze(cfg.name, shape, "1x1", 1, cfg)
    af = roof.analytic_flops(cfg, shape)
    hbm = roof.analytic_hbm_bytes(cfg, shape, 1)
    assert r.compute_s == af / 989e12
    assert r.memory_s == hbm / 3.35e12
    assert r.collective_s == 0.0 and r.collective_breakdown == {}
    assert r.hlo_flops_per_device == r.hlo_bytes_per_device == 0.0
    assert r.dominant == "memory"            # decode reads every weight
    assert r.total_s == max(r.compute_s, r.memory_s)
    assert r.useful_flops_ratio == roof.model_flops(cfg, shape) / af
    # four chips split the FLOPs, and the ratio counts all of them
    r4 = roof.analyze(cfg.name, shape, "1x4", 4, cfg)
    _close(r4.analytic_flops_per_device * 4, af)
    _close(r4.useful_flops_ratio, r.useful_flops_ratio)
    path = tmp_path / "out" / "r.json"
    roof.save_report(str(path), r)
    row = json.loads(path.read_text())
    assert row["memory_s"] == r.memory_s and row["dominant"] == "memory"
    assert set(row) >= {"compute_s", "memory_s", "collective_s", "total_s",
                        "useful_flops_ratio", "model_flops_total"}


def test_families_without_a_port_config_raise():
    # RWKV's ssm family has its config now: its terms are the JAX package's
    cfg, jcfg = get_config("rwkv6-7b"), jax_get_config("rwkv6-7b")
    shape, jshape = base.INPUT_SHAPES["train_4k"], jbase.INPUT_SHAPES["train_4k"]
    _close(roof.analytic_flops(cfg, shape), jroof.analytic_flops(jcfg, jshape))
    _close(roof.analytic_hbm_bytes(cfg, shape, 1),
           jroof.analytic_hbm_bytes(jcfg, jshape, 1))
    _close(roof.model_flops(cfg, shape), jroof.model_flops(jcfg, jshape))
    with pytest.raises(NotImplementedError):
        dataclasses.replace(get_config("mixtral-8x7b"),
                            attention="mla").num_params()
