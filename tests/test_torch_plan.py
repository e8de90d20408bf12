"""The port's planner (``apex_tpu_torch.parallel.plan``'s cost model,
search, tables and CLI) against the JAX package's ``parallel.plan``.

- On hand-built ``ModelProfile``s the port's ``compute_time_s``,
  ``collective_time_s``, ``plan_hbm_bytes``, ``predict``,
  ``enumerate_plans``, ``search`` and ``format_plans`` give JAX's floats
  and strings exactly, over the families, the dp wire schemes, 1 / 2 / 4 /
  8 chips and three ceilings rows: the cpu row (the same numbers in both
  packages), the port's h100 row and a two-slice row with DCN terms.
- The JAX tests' oracles (``tests/L0/test_plan.py``), each against its
  closed form: the 2-chip ring all-reduce, the int8 wire and codec, the
  roofline, the HBM scaling, the flagship's enumeration at 8 chips, the
  search's pruning against ``memory_model()``, the tie break, int8 on a
  slow and a fast wire, pp / ep candidates, the pp bubble and wire, the ep
  wire, the pp stash and ep buffers.
- ``profile_step`` runs the step once: a 64^3 matmul's FLOPs are 2 M N K;
  the stand-in flagship step's FLOPs equal ``FlopCounterMode``'s count of
  the same step (the JAX op table's count is not the bar: XLA's is off);
  the collectives the step issues reach ``collective_bytes``.
- The re-plan hook installs and restores; the CLI renders an artifact and
  a fresh CPU run.
"""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest

import jax
import torch

from apex_tpu.parallel import plan as jplan

from apex_tpu_torch.parallel import collectives as pcoll
from apex_tpu_torch.parallel import plan as pplan
from apex_tpu_torch.pyprof.prof import HW_CEILINGS

import _torch_dist

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_DEV = 8
#: the JAX tests' explicit ceilings
CEIL = {"peak_flops": 1e12, "peak_bw": 1e11, "ici_bw": 1e10,
        "ici_alpha_s": 1e-6, "hbm_bytes": 1e12}
ROWS = {
    "cpu": dict(HW_CEILINGS["cpu"]),
    "h100": dict(HW_CEILINGS["h100"]),
    "dcn2": dict(HW_CEILINGS["h100"], num_slices=2, dcn_bw=2.5e10,
                 dcn_alpha_s=2e-5),
}


@pytest.fixture(autouse=True)
def _clean_env():
    keys = ("APEX_TPU_COLLECTIVES", "APEX_TPU_UPDATE_SHARDING",
            "APEX_TPU_CEILINGS", pplan.ENV_OVERLAP)
    saved = {k: os.environ.pop(k, None) for k in keys}
    yield
    for k, v in saved.items():
        os.environ.pop(k, None)
        if v is not None:
            os.environ[k] = v


def _synth(mod, **kw):
    base = dict(name="synth", flops=1e9, bytes_accessed=1e8,
                params_bytes=4096, optimizer_bytes=12288,
                activations_bytes=8192, batch_bytes=1024,
                temps_bytes=512, output_bytes=64, args_bytes=16,
                constants_bytes=8, peak_hbm_bytes=30000,
                layers=2, act_layer_bytes=4096, seq=64, heads=4,
                platform="cpu")
    base.update(kw)
    return mod.ModelProfile(**base)


#: hand-built profiles: the JAX tests' synthetic one, a BERT-large-sized
#: step (the order of the card profile), a long-sequence one (sp plans)
#: and an MoE one (ep plans, a profiled all-to-all sub-table)
PROFILES = {
    "synth": dict(),
    "bert": dict(flops=1.6e13, bytes_accessed=9e11, params_bytes=1.34e9,
                 optimizer_bytes=4.0e9, activations_bytes=2.6e10,
                 batch_bytes=32768, temps_bytes=3e9, output_bytes=1.3e9,
                 peak_hbm_bytes=3.6e10, layers=24,
                 act_layer_bytes=8 * 512 * 1024 * 4, seq=512, heads=16,
                 global_batch=8),
    "long": dict(seq=4096, heads=8, global_batch=8, layers=4,
                 act_layer_bytes=8 * 4096 * 64 * 4),
    "moe": dict(global_batch=8, experts=8, collective_bytes={
        "all-to-all": {"logical_bytes": 1 << 20, "count": 4}}),
}

PLANS = [dict(dp=8), dict(dp=4, tp=2), dict(dp=2, tp=4),
         dict(dp=4, update_sharding="zero1"),
         dict(dp=8, collective_scheme="bf16"),
         dict(dp=8, collective_scheme="int8_blockscale"),
         dict(dp=4, update_sharding="zero1",
              collective_scheme="int8_blockscale",
              allgather_scheme="int8_blockscale"),
         dict(dp=8, zero=True), dict(dp=4, sp=2, sp_strategy="ring"),
         dict(dp=2, sp=4, sp_strategy="ulysses"),
         dict(dp=4, pp_stages=2, pp_microbatches=2), dict(dp=4, ep=2),
         dict(dp=1, tp=1)]


def _same_plan(p, j):
    assert p.knobs() == j.knobs()
    assert p.predicted_step_ms == j.predicted_step_ms
    assert p.predicted_hbm_bytes == j.predicted_hbm_bytes
    assert p.hbm_by_class == j.hbm_by_class
    assert p.breakdown == j.breakdown
    assert p.feasible == j.feasible


@pytest.mark.parametrize("row", list(ROWS))
@pytest.mark.parametrize("prof", list(PROFILES))
def test_predict_and_hbm_equal_jax(prof, row):
    ceil = ROWS[row]
    pp_, jp = _synth(pplan, **PROFILES[prof]), _synth(jplan,
                                                      **PROFILES[prof])
    for knobs in PLANS:
        p = pplan.predict(pp_, pplan.Plan(**knobs), ceilings=ceil)
        j = jplan.predict(jp, jplan.Plan(**knobs), ceilings=ceil)
        _same_plan(p, j)
        assert pplan.plan_hbm_bytes(pp_, pplan.Plan(**knobs)) == \
            jplan.plan_hbm_bytes(jp, jplan.Plan(**knobs))
    p = pplan.predict(pp_, pplan.Plan(dp=8), ceilings=ceil,
                      overlap_fraction=0.25)
    j = jplan.predict(jp, jplan.Plan(dp=8), ceilings=ceil,
                      overlap_fraction=0.25)
    _same_plan(p, j)


@pytest.mark.parametrize("row", list(ROWS))
@pytest.mark.parametrize("chips", [1, 2, 4, 8])
@pytest.mark.parametrize("prof", list(PROFILES))
def test_enumerate_search_and_table_equal_jax(prof, chips, row):
    ceil = ROWS[row]
    pp_, jp = _synth(pplan, **PROFILES[prof]), _synth(jplan,
                                                      **PROFILES[prof])
    pe = pplan.enumerate_plans(pp_, chips, ceilings=ceil)
    je = jplan.enumerate_plans(jp, chips, ceilings=ceil)
    assert len(pe) == len(je)
    for p, j in zip(pe, je):
        _same_plan(p, j)
    cap = int(np.median([p.predicted_hbm_bytes for p in pe])) if pe \
        else None
    ceil1 = dict(ceil, num_slices=ceil.get("num_slices", 1))
    for capacity in (None, cap):
        ps = pplan.search(pp_, chips, ceilings=ceil1,
                          capacity_bytes=capacity)
        js = jplan.search(jp, chips, ceilings=ceil1,
                          capacity_bytes=capacity)
        assert [p.knobs() for p in ps] == [j.knobs() for j in js]
        assert pplan.format_plans(ps, chips=chips) == \
            jplan.format_plans(js, chips=chips)


@pytest.mark.parametrize("kind", ["all_reduce", "reduce_scatter",
                                  "all_gather", "all_to_all", "ppermute"])
@pytest.mark.parametrize("scheme", list(pplan.PLAN_SCHEMES))
@pytest.mark.parametrize("row", list(ROWS))
def test_collective_and_compute_time_equal_jax(kind, scheme, row):
    ceil = ROWS[row]
    for world in (1, 2, 4, 8):
        for nbytes in (0, 4096, 4 * (1 << 20), 3e9):
            for slices in (1, 2):
                assert pplan.collective_time_s(
                    kind, nbytes, world, ceil, scheme, slices=slices) == \
                    jplan.collective_time_s(kind, nbytes, world, ceil,
                                            scheme, slices=slices)
    for f, b in ((1e9, 0.0), (0.0, 1e9), (3e12, 4e10)):
        assert pplan.compute_time_s(f, b, ceil) == \
            jplan.compute_time_s(f, b, ceil)


def test_constants_and_overlap_match_jax():
    for name in ("PLAN_SCHEMES", "TUNING_KEYS", "ENV_OVERLAP",
                 "UPDATE_FLOPS_PER_PARAM", "UPDATE_BYTES_PER_PARAM",
                 "DEFAULT_TIE_TOL", "SP_MIN_SEQ", "EP_DEFAULT_EXPERTS"):
        assert getattr(pplan, name) == getattr(jplan, name), name
    assert pplan.resolve_overlap_fraction() == 1.0
    assert pplan.resolve_overlap_fraction(1.7) == 1.0
    assert pplan.resolve_overlap_fraction(-1.0) == 0.0
    os.environ[pplan.ENV_OVERLAP] = "0.4"
    assert pplan.resolve_overlap_fraction() == 0.4 == \
        jplan.resolve_overlap_fraction()
    assert pplan.resolve_overlap_fraction(0.2) == 0.2


# ---------------------------------------------------------------------------
# the JAX tests' oracles
# ---------------------------------------------------------------------------

def test_collective_time_oracle_2chip_ring_allreduce():
    logical = 4 * (1 << 20)
    t = pplan.collective_time_s("all_reduce", logical, 2, CEIL)
    assert t == pytest.approx(2 * 1e-6 + 1.0 * logical / 1e10)
    t_rs = pplan.collective_time_s("reduce_scatter", logical, 2, CEIL)
    assert t_rs == pytest.approx(1e-6 + 0.5 * logical / 1e10)
    assert pplan.collective_time_s("all_gather", logical, 2, CEIL) == t_rs
    assert pplan.collective_time_s("all_reduce", logical, 1, CEIL) == 0.0
    assert pplan.collective_time_s("all_reduce", 0, 8, CEIL) == 0.0
    with pytest.raises(ValueError, match="unknown collective"):
        pplan.collective_time_s("gossip", logical, 2, CEIL)


def test_collective_time_scheme_wire_and_codec():
    logical = 4 * (1 << 20)
    world = 8
    wire = pcoll.wire_bytes("int8_blockscale", logical // 4)
    expected = (2 * (world - 1) * CEIL["ici_alpha_s"]
                + 2.0 * (world - 1) / world * wire / CEIL["ici_bw"]
                + (1 + world) * logical / CEIL["peak_bw"])
    t8 = pplan.collective_time_s("all_reduce", logical, world, CEIL,
                                 "int8_blockscale")
    assert t8 == pytest.approx(expected)
    assert t8 < pplan.collective_time_s("all_reduce", logical, world, CEIL)
    fast = dict(CEIL, ici_bw=CEIL["peak_bw"])
    assert pplan.collective_time_s("all_reduce", logical, world, fast,
                                   "int8_blockscale") > \
        pplan.collective_time_s("all_reduce", logical, world, fast)


def test_compute_time_known_flops_matmul():
    a = torch.ones(64, 64)
    prof = pplan.profile_step(lambda x, y: x @ y, a, a, name="matmul")
    assert prof.flops == 2 * 64 ** 3
    assert prof.platform == "cpu"
    t = pplan.compute_time_s(prof.flops, 0.0, CEIL)
    assert t == pytest.approx(prof.flops / CEIL["peak_flops"])
    assert pplan.compute_time_s(0.0, 1e9, CEIL) == pytest.approx(1e9 / 1e11)


def _psum_profile(rank, world):
    import torch.distributed as dist
    from apex_tpu_torch.parallel import plan

    def fn(x):
        dist.all_reduce(x)
        return x

    return plan.profile_step(fn, torch.ones(1024), name="psum") \
        .collective_bytes


def test_profile_step_surfaces_the_collectives(tmp_path):
    coll = _torch_dist.run_in_process(_psum_profile, tmp_path)
    (agg,) = coll.values()
    assert agg["count"] == 1 and agg["logical_bytes"] == 1024 * 4


def test_hbm_scaling_semantics():
    prof = _synth(pplan)
    total, by = pplan.plan_hbm_bytes(prof, pplan.Plan(dp=8))
    assert by["params"] == 4096 and by["optimizer"] == 12288
    assert by["activations"] == 8192 // 8 and by["batch"] == 1024 // 8
    assert total == sum(by.values())
    _, by_z = pplan.plan_hbm_bytes(prof, pplan.Plan(
        dp=8, update_sharding="zero1"))
    assert by_z["optimizer"] == 12288 // 8
    _, by_tp = pplan.plan_hbm_bytes(prof, pplan.Plan(dp=4, tp=2))
    assert by_tp["params"] == 4096 // 2
    assert by_tp["optimizer"] == 12288 // 2
    assert by_tp["activations"] == 8192 // 8


@pytest.fixture(scope="module")
def flagship():
    """(profile, memory_model) of the stand-in flagship step on the CPU,
    the memory model recomputed on its own."""
    from apex_tpu_torch.telemetry import memory as tmem
    cfg = pplan._flagship_cfg(False)
    step, args = pplan._flagship_step(cfg, 8, "cpu")
    prof = pplan.profile_step(step, *args, name="flagship-test", cfg=cfg,
                              global_batch=8)
    return prof, tmem.memory_model(step, *args, register=False), step, args


def test_flagship_profile_flops_are_flop_counter_modes(flagship):
    """The profile's FLOPs are the op table's total over the executed
    step; its products are ``FlopCounterMode``'s count of the same step
    and the closed form: 3 x the forward's products (the backward's two
    products per product), the forward's per layer 2 T D (3D + D + 2F) of
    the projections and 2 x 2 B S^2 D of the scores and the context, plus
    the tied head's 2 T D V (T = B S tokens)."""
    from torch.utils.flop_counter import FlopCounterMode
    from apex_tpu_torch.telemetry import attrib
    prof, _, step, args = flagship
    table = attrib.op_table(step, *args)
    assert prof.flops == table["total_flops"]
    with FlopCounterMode(display=False) as fc:
        step(*args)
    cfg = pplan._flagship_cfg(False)
    L, D, F, V = cfg.num_layers, cfg.d_model, cfg.d_ff, cfg.vocab_size
    B, S = 8, cfg.max_len
    T = B * S
    fwd = L * (2 * T * D * (3 * D + D + 2 * F) + 2 * 2 * B * S * S * D) \
        + 2 * T * D * V
    assert table["by_class"]["blas"]["flops"] == fc.get_total_flops() \
        == 3 * fwd
    assert prof.flops > 3 * fwd
    assert prof.layers == L and prof.heads == cfg.num_heads
    assert prof.act_layer_bytes == T * D * 4
    assert prof.global_batch == 8 and prof.platform == "cpu"


def test_enumerate_flagship_8chips_ge_12_candidates(flagship):
    prof = flagship[0]
    plans = pplan.enumerate_plans(prof, N_DEV, platform="cpu")
    assert len(plans) >= 12
    assert all(p.chips == N_DEV for p in plans)
    assert any(p.tp > 1 for p in plans)
    assert any(p.zero for p in plans)
    assert any(p.update_sharding == "zero1" for p in plans)
    assert {p.collective_scheme for p in plans if p.dp > 1} == \
        set(pplan.PLAN_SCHEMES)
    assert all(p.sp == 1 for p in plans)
    long = _synth(pplan, seq=4096, heads=8)
    sp = [p for p in pplan.enumerate_plans(long, N_DEV, platform="cpu")
          if p.sp > 1]
    assert {p.sp_strategy for p in sp} == {"ring", "ulysses"}
    assert all(p.measurable for p in plans)


def test_search_prunes_all_infeasible_against_memory_model(flagship):
    prof, mm, _, _ = flagship
    assert prof.params_bytes == mm["params_bytes"]
    assert prof.optimizer_bytes == mm["optimizer_bytes"]
    assert prof.activations_bytes == mm["activations_bytes"]
    all_plans = pplan.enumerate_plans(prof, N_DEV, platform="cpu")
    demands = sorted(p.predicted_hbm_bytes for p in all_plans)
    cap = demands[len(demands) // 2]
    ranked = pplan.search(prof, N_DEV, platform="cpu", capacity_bytes=cap)
    assert ranked and len(ranked) < len(all_plans)

    def hbm(p):
        pp, ep = p.pp_stages, p.ep
        opt_div = p.tp * pp * (p.dp if p.shards_update else 1)
        total = (mm["params_bytes"] // (p.tp * pp)
                 + mm["optimizer_bytes"] // opt_div
                 + mm["activations_bytes"] // (p.dp * p.tp * p.sp * pp * ep)
                 + mm["batch_bytes"] // (p.dp * p.sp * ep)
                 + mm["temps_bytes"] // (p.dp * p.tp * p.sp * ep)
                 + mm["output_bytes"] // (p.dp * ep)
                 + mm["args_bytes"] + mm["constants_bytes"])
        if pp > 1:
            m = max(int(p.pp_microbatches), 1)
            total += (m + pp - 1 + m) * (
                prof.act_layer_bytes // max(p.dp * m, 1))
        if ep > 1:
            e, c, d, t = pplan._ep_geometry(prof, p.dp, ep, p.sp)
            total += 4 * (2 * t * e * c + 2 * e * c * d)
        return total

    for p in ranked:
        assert hbm(p) <= cap, p.describe()
    assert any(hbm(p) > cap for p in all_plans)


def test_tie_break_prefers_simpler_plan():
    prof = _synth(pplan, params_bytes=512, optimizer_bytes=1536, layers=0)
    ranked = pplan.search(prof, N_DEV, ceilings=CEIL)
    assert ranked[0].knobs() == pplan.default_plan(N_DEV).knobs()


def test_int8_wins_on_a_slow_wire_loses_on_cpu(flagship):
    """The codec model: with the h100 row's wire (NVLink, 7x slower than
    memory) the int8 dp wire beats fp32 on the flagship's gradients; on
    the cpu row (wire ~ memory) it loses."""
    prof = flagship[0]
    big = dataclasses.replace(prof, params_bytes=prof.params_bytes * 1000,
                              grad_bytes=prof.grad_bytes * 1000)

    def dp_comm(row, scheme):
        return pplan.predict(big, pplan.Plan(dp=N_DEV,
                                             collective_scheme=scheme),
                             ceilings=ROWS[row]).breakdown["dp_comm_ms"]

    assert dp_comm("h100", "int8_blockscale") < dp_comm("h100", "fp32")
    assert dp_comm("cpu", "int8_blockscale") > dp_comm("cpu", "fp32")


def test_enumerate_pp_ep_candidates(flagship):
    prof = flagship[0]
    plans = pplan.enumerate_plans(prof, N_DEV, platform="cpu")
    pps = [p for p in plans if p.pp_stages > 1]
    eps = [p for p in plans if p.ep > 1]
    assert len(pps) >= 2 and len(eps) >= 2
    for p in pps:
        assert prof.layers % p.pp_stages == 0
        assert (prof.global_batch // p.dp) % p.pp_microbatches == 0
        assert p.tp == p.sp == p.ep == 1
        assert not p.zero and p.update_sharding == "off"
        assert p.family == "pp" and p.measurable
    for p in eps:
        assert (prof.experts or pplan.EP_DEFAULT_EXPERTS) % p.ep == 0
        assert p.tp == p.sp == p.pp_stages == 1
        assert not p.zero and p.update_sharding == "off"
        assert p.family == "ep" and p.measurable
    assert len({p.pp_microbatches for p in pps}) >= 2
    assert pplan.Plan(dp=4, pp_stages=2,
                      pp_microbatches=2).describe() == "dp=4 pp=2x2"
    assert pplan.Plan(dp=4, ep=2).describe() == "dp=4 ep=2"


def test_pp_cost_model_bubble_and_wire_oracle():
    prof = _synth(pplan, global_batch=8)
    bd = pplan.predict(prof, pplan.Plan(dp=4, pp_stages=2,
                                        pp_microbatches=2),
                       ceilings=CEIL).breakdown
    assert bd["pp_bubble_ms"] == pytest.approx(bd["train_ms"] / 2)
    blk = prof.act_layer_bytes / (4 * 2)
    want = 2 * (2 + 2 - 1) * pplan.collective_time_s("ppermute", blk, 2,
                                                     CEIL)
    assert bd["pp_comm_ms"] == pytest.approx(want * 1e3)
    p1 = pplan.predict(prof, pplan.Plan(dp=4, pp_stages=2,
                                        pp_microbatches=1), ceilings=CEIL)
    assert p1.breakdown["pp_bubble_ms"] > bd["pp_bubble_ms"]
    dense = pplan.predict(prof, pplan.Plan(dp=8), ceilings=CEIL).breakdown
    assert dense["pp_bubble_ms"] == dense["pp_comm_ms"] == 0.0


def test_ep_cost_model_capacity_wire_and_profiled_subtable():
    prof = _synth(pplan, global_batch=8, experts=8)
    p = pplan.predict(prof, pplan.Plan(dp=4, ep=2), ceilings=CEIL)
    e, cap, d_model, _ = pplan._ep_geometry(prof, 4, 2)
    want = 4 * prof.layers * pplan.collective_time_s(
        "all_to_all", 4.0 * e * cap * d_model, 2, CEIL)
    assert p.breakdown["ep_comm_ms"] == pytest.approx(want * 1e3)
    prof2 = _synth(pplan, global_batch=8, experts=8, collective_bytes={
        "all-to-all": {"logical_bytes": 1 << 20, "count": 4}})
    p2 = pplan.predict(prof2, pplan.Plan(dp=4, ep=2), ceilings=CEIL)
    want2 = 2 * 4 * pplan.collective_time_s("all_to_all", (1 << 20) / 4, 2,
                                            CEIL)
    assert p2.breakdown["ep_comm_ms"] == pytest.approx(want2 * 1e3)
    assert pplan.predict(prof, pplan.Plan(dp=8), ceilings=CEIL) \
        .breakdown["ep_comm_ms"] == 0.0


def test_tp_cost_model_is_four_activation_all_reduces_a_layer():
    """Megatron's column / row pairs: 4 all-reduces of one layer's
    activation block (per dp replica) a layer, over the tp axis."""
    prof = _synth(pplan, global_batch=8)
    p = pplan.predict(prof, pplan.Plan(dp=2, tp=4), ceilings=CEIL)
    want = 4 * prof.layers * pplan.collective_time_s(
        "all_reduce", prof.act_layer_bytes / 2, 4, CEIL)
    assert p.breakdown["tp_comm_ms"] == pytest.approx(want * 1e3)
    assert pplan.predict(prof, pplan.Plan(dp=8), ceilings=CEIL) \
        .breakdown["tp_comm_ms"] == 0.0


def test_hbm_charges_pp_stash_and_ep_buffers():
    prof = _synth(pplan, global_batch=8, experts=8)
    _, by_pp = pplan.plan_hbm_bytes(prof, pplan.Plan(dp=4, pp_stages=2,
                                                     pp_microbatches=2))
    blk = prof.act_layer_bytes // (4 * 2)
    assert by_pp["pp_stash"] == (2 + 2 - 1 + 2) * blk
    assert by_pp["params"] == prof.params_bytes // 2
    _, by_ep = pplan.plan_hbm_bytes(prof, pplan.Plan(dp=4, ep=2))
    e, cap, d_model, t_local = pplan._ep_geometry(prof, 4, 2)
    assert by_ep["ep_buffers"] == 4 * (2 * t_local * e * cap
                                       + 2 * e * cap * d_model)
    _, by_d = pplan.plan_hbm_bytes(prof, pplan.Plan(dp=8))
    assert "pp_stash" not in by_d and "ep_buffers" not in by_d


def test_replan_hook_installs_and_restores():
    def hook(plan, chips):
        return pplan.Plan(dp=chips)

    prev = pplan.set_replan_hook(hook)
    try:
        assert pplan.get_replan_hook() is hook
    finally:
        assert pplan.set_replan_hook(prev) is hook
    assert pplan.get_replan_hook() is prev


def test_plan_fields_and_artifact_rows():
    plans, measured = pplan._plans_from_artifact({"plan": {"plans": [
        {"knobs": {"dp": 8, "update_sharding": "zero1"},
         "predicted_ms": 1.5, "measured_ms": 1.4, "hbm_bytes": 1 << 20},
        {"knobs": {"dp": 8}, "predicted_ms": 2.0, "hbm_bytes": 1 << 20}]}})
    jp, jm = jplan._plans_from_artifact({"plan": {"plans": [
        {"knobs": {"dp": 8, "update_sharding": "zero1"},
         "predicted_ms": 1.5, "measured_ms": 1.4, "hbm_bytes": 1 << 20},
        {"knobs": {"dp": 8}, "predicted_ms": 2.0, "hbm_bytes": 1 << 20}]}})
    assert measured == jm == {0: 1.4}
    assert pplan.format_plans(plans, measured=measured) == \
        jplan.format_plans(jp, measured=jm)
    with pytest.raises(ValueError, match="no plan leg"):
        pplan._plans_from_artifact({"detail": {}})


def test_cli_renders_artifact_and_fresh_run(tmp_path):
    art = {"metric": "plan_ab", "backend": "cpu", "plan": {
        "leg": "plan", "chips": 8, "plans": [
            {"knobs": {"dp": 8, "update_sharding": "zero1"},
             "predicted_ms": 1.5, "measured_ms": 1.4,
             "hbm_bytes": 1 << 20},
            {"knobs": {"dp": 8}, "predicted_ms": 2.0,
             "measured_ms": 2.0, "hbm_bytes": 1 << 20}]}}
    path = tmp_path / "plan_ab.json"
    path.write_text(json.dumps(art))
    env = {**os.environ, "PYTHONPATH": ROOT}
    r = subprocess.run(
        [sys.executable, "-m", "apex_tpu_torch.parallel.plan",
         "--artifact", str(path)],
        capture_output=True, text=True, env=env, timeout=120, cwd=ROOT)
    assert r.returncode == 0, r.stderr
    assert "winner knobs" in r.stdout and "us=zero1" in r.stdout
    assert "1.400" in r.stdout
    r2 = subprocess.run(
        [sys.executable, "-m", "apex_tpu_torch.parallel.plan",
         "--device", "cpu", "--chips", "8", "--model", "flagship",
         "--layers", "1", "--seq", "16", "--batch", "8"],
        capture_output=True, text=True, env=env, timeout=300, cwd=ROOT)
    assert r2.returncode == 0, r2.stderr
    assert "HBM-feasible" in r2.stdout and "winner knobs" in r2.stdout
    assert "on cpu" in r2.stdout
