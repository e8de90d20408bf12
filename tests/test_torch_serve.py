"""The port's serving engine and scheduler against the JAX package's.

Both fp32 ``InferenceEngine``s get the same parameters (the JAX pytree
carried across with ``params_from_jax``); prefill and decode logits agree
to 1e-4, and a greedy ``ContinuousBatcher`` run of six requests gives the
same tokens.  The JAX engine's bitwise claims are not the port's bar: the
port is held to these tolerances.  Within the port: sampled replay is
deterministic, pool exhaustion sheds with the typed error, one host read
per scheduler step, and the ledger passes the JAX package's
``serve_violations``.  With a registry and a tracer, the port's scheduler
emits the JAX scheduler's ``serve.*`` event sequence on the same
requests, its ``serve.prefill`` / ``serve.decode`` spans and ``serve.*``
gauges; a ``request_flood`` fault submits its burst in both; the
serve-ledger CLI renders the port's ``SERVE.json``.
"""
import numpy as np
import pytest

import jax
import torch

from apex_tpu.models import TransformerConfig as JaxConfig
from apex_tpu.models import transformer_init as jax_init
from apex_tpu.serve import CacheConfig as JaxCache
from apex_tpu.serve import ContinuousBatcher as JaxBatcher
from apex_tpu.serve import InferenceEngine as JaxEngine
from apex_tpu.serve import Request as JaxRequest
from apex_tpu.resilience import faults as jax_faults
from apex_tpu.telemetry import registry as jax_registry
from apex_tpu.telemetry import trace as jax_trace
from apex_tpu.telemetry.serve_ledger import serve_violations

from apex_tpu_torch.models import TransformerConfig, params_from_jax
from apex_tpu_torch.resilience import faults as port_faults
from apex_tpu_torch.telemetry import registry as port_registry
from apex_tpu_torch.telemetry import serve_ledger as port_serve_ledger
from apex_tpu_torch.telemetry import trace as port_trace
from apex_tpu_torch.serve import (CacheConfig, ContinuousBatcher,
                                  InferenceEngine, KVCacheExhaustedError,
                                  PagePool, Request, prepare_olevel,
                                  request_key, sample_token)

DIMS = dict(vocab_size=64, max_len=32, num_layers=2, d_model=32,
            num_heads=2, d_ff=64)
CACHE = dict(page_size=8, num_pages=16, max_ctx=32)
TOL = 1e-4


@pytest.fixture(scope="module")
def jax_params():
    return jax_init(jax.random.PRNGKey(0), JaxConfig(**DIMS, causal=True))


@pytest.fixture(scope="module")
def port_params(jax_params):
    return params_from_jax(jax.tree_util.tree_map(np.asarray, jax_params),
                           device="cpu")


def _port_engine(params, attn_impl="fast", width=4, olevel="fp32", **cache):
    return InferenceEngine(
        params, TransformerConfig(**DIMS, causal=True, attn_impl=attn_impl),
        cache=CacheConfig(**{**CACHE, **cache}), olevel=olevel,
        decode_width=width, device="cpu")


def _jax_engine(params, attn_impl="fast", width=4):
    return JaxEngine(params, JaxConfig(**DIMS, causal=True,
                                       attn_impl=attn_impl),
                     cache=JaxCache(**CACHE), olevel="fp32",
                     decode_width=width)


@pytest.mark.parametrize("attn_impl", ["fast", "default"])
def test_prefill_and_decode_logits_match_jax(jax_params, port_params,
                                             attn_impl):
    jeng = _jax_engine(jax_params, attn_impl)
    peng = _port_engine(port_params, attn_impl)
    rng = np.random.default_rng(2)
    W, PPR, S = 4, 4, CACHE["max_ctx"]
    reqs = [(11, [1, 2, 0, 0]), (7, [3, 4, 0, 0])]    # (prompt_len, pages)
    tables = np.zeros((W, PPR), np.int32)
    cur = np.zeros(W, np.int32)
    pos = np.zeros(W, np.int32)
    for w, (plen, pages) in enumerate(reqs):
        tokens = np.zeros(S, np.int32)
        tokens[:plen] = rng.integers(1, DIMS["vocab_size"], plen)
        jfirst, jlast = jeng.prefill(tokens, plen, np.array(pages, np.int32),
                                     seed=w)
        pfirst, plast = peng.prefill(tokens, plen, np.array(pages), seed=w)
        np.testing.assert_allclose(plast.numpy(), np.asarray(jlast),
                                   atol=TOL, rtol=TOL)
        assert int(pfirst) == int(jfirst)
        tables[w] = pages
        cur[w], pos[w] = int(jfirst), plen
    zeros = np.zeros(W, np.int32)
    for _ in range(3):
        jtok, jlog = jeng.decode_step(cur, pos, tables, zeros,
                                      np.zeros(W, np.float32), zeros)
        ptok, plog = peng.decode_step(cur, pos, tables, zeros,
                                      np.zeros(W, np.float32), zeros)
        np.testing.assert_allclose(plog.numpy()[:2], np.asarray(jlog)[:2],
                                   atol=TOL, rtol=TOL)
        np.testing.assert_array_equal(ptok.numpy()[:2], np.asarray(jtok)[:2])
        cur[:2] = np.asarray(jtok)[:2]
        pos[:2] += 1


def _specs(n=6, sampled=False, seed=4):
    rng = np.random.default_rng(seed)
    return [dict(rid=f"r{i}",
                 prompt=rng.integers(1, DIMS["vocab_size"],
                                     int(rng.integers(3, 21))).tolist(),
                 max_new_tokens=int(rng.integers(5, 9)),
                 temperature=0.8 if sampled else 0.0,
                 top_k=8 if sampled else 0, seed=i) for i in range(n)]


def test_greedy_batcher_tokens_match_jax(jax_params, port_params):
    jbat = JaxBatcher(_jax_engine(jax_params))
    pbat = ContinuousBatcher(_port_engine(port_params))
    for spec in _specs():
        jbat.submit(JaxRequest(**spec))
        pbat.submit(Request(**spec))
    jres, pres = jbat.run(), pbat.run()
    assert set(pres) == set(jres)
    for rid, r in pres.items():
        assert r.status == jres[rid].status == "done"
        assert r.tokens == jres[rid].tokens, rid
    assert pbat.pool.free_pages == CACHE["num_pages"] - 1


def test_sampled_replay_is_deterministic(port_params):
    eng = _port_engine(port_params)
    bat = ContinuousBatcher(eng)
    specs = _specs(sampled=True, seed=9)
    for spec in specs:
        bat.submit(Request(**spec))
    batched = bat.run()
    for spec in specs[::2]:
        solo = ContinuousBatcher(eng)
        solo.submit(Request(**spec))
        assert solo.run()[spec["rid"]].tokens == batched[spec["rid"]].tokens


def test_one_host_read_per_step_and_ledger_valid(port_params):
    bat = ContinuousBatcher(_port_engine(port_params))
    for spec in _specs(seed=1):
        bat.submit(Request(**spec))
    res = bat.run()
    assert all(r.status == "done" for r in res.values())
    assert bat.host_reads == bat._step_idx > 0
    doc = bat.ledger.snapshot(olevel="fp32", decode_width=4)
    assert serve_violations(doc) == []
    assert doc["requests"]["served"] == 6
    assert doc["partition_error_us"] == 0


def test_eos_stops_early(port_params):
    eng = _port_engine(port_params)
    spec = _specs(n=1, seed=3)[0]
    full = ContinuousBatcher(eng)
    full.submit(Request(**spec))
    tokens = full.run()[spec["rid"]].tokens
    eos = tokens[2]
    bat = ContinuousBatcher(eng)
    bat.submit(Request(**{**spec, "eos_id": eos}))
    got = bat.run()[spec["rid"]]
    assert got.status == "done"
    assert got.tokens == tokens[:tokens.index(eos) + 1]


def test_pool_exhaustion_sheds_typed(port_params):
    # 3 usable pages: a 20-token prompt takes all of them
    bat = ContinuousBatcher(_port_engine(port_params, num_pages=4))
    bat.submit(Request(rid="big", prompt=[1] * 20, max_new_tokens=4))
    bat.submit(Request(rid="starved", prompt=[2] * 9, max_new_tokens=4))
    bat.submit(Request(rid="long", prompt=[3] * CACHE["max_ctx"]))
    res = bat.run()
    assert res["big"].status == "done"
    assert res["starved"].status == "shed"
    assert res["starved"].reason == "kv_cache_exhausted"
    assert res["long"].status == "shed"
    assert res["long"].reason == "prompt_too_long"
    assert bat.pool.free_pages == 3
    doc = bat.ledger.snapshot()
    assert doc["requests"]["shed"] == 2
    assert serve_violations(doc) == []


def test_page_pool_typed_error():
    pool = PagePool(CacheConfig(**CACHE))
    pool.alloc(10)
    with pytest.raises(KVCacheExhaustedError) as err:
        pool.alloc(10)
    assert (err.value.requested, err.value.free) == (10, 5)


def test_engine_validation(port_params):
    with pytest.raises(ValueError, match="decode_width"):
        _port_engine(port_params, width=1)
    with pytest.raises(ValueError, match="max_len"):
        _port_engine(port_params, max_ctx=64)
    with pytest.raises(ValueError, match="d_model"):
        InferenceEngine(port_params,
                        TransformerConfig(**{**DIMS, "num_heads": 3}),
                        cache=CacheConfig(**CACHE), device="cpu")


def test_olevels(port_params):
    packed, unpack, dt, ratio = prepare_olevel(port_params, "int8")
    assert dt == torch.bfloat16 and ratio > 3.5
    assert unpack(packed)["layers"]["wqkv"].dtype == torch.bfloat16
    with pytest.raises(ValueError):
        prepare_olevel(port_params, "fp8")
    packed, unpack, dt, ratio = prepare_olevel(port_params, "bf16")
    assert dt == torch.bfloat16 and ratio is None
    assert unpack(packed)["layers"]["wqkv"].dtype == torch.bfloat16
    eng = _port_engine(port_params, olevel="bf16")
    assert eng.k_pool.dtype == torch.bfloat16
    assert eng.k_pool.shape == (2, CACHE["num_pages"], CACHE["page_size"],
                                2, 16)


def test_int8_packing_is_the_jax_codec_bit_for_bit(jax_params, port_params):
    """int8: every float leaf of two or more dimensions packed as the JAX
    ``prepare_olevel`` packs it (codes and scales bit-equal), the rest
    bf16; the same compression ratio; the unpacked weights equal."""
    from apex_tpu.serve.engine import prepare_olevel as jax_prepare
    jpacked, junpack, _, jratio = jax_prepare(jax_params, "int8")
    packed, unpack, _, ratio = prepare_olevel(port_params, "int8")
    assert ratio == pytest.approx(jratio, rel=0, abs=1e-12)
    assert len(packed) == len(jpacked)
    for got, ref in zip(packed, jpacked):
        if isinstance(ref, tuple):
            np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
            np.testing.assert_array_equal(
                got[1].numpy().view(np.int32),
                np.asarray(ref[1]).view(np.int32))
        else:
            assert got.dtype == torch.bfloat16
            np.testing.assert_array_equal(got.float().numpy(),
                                          np.asarray(ref, np.float32))
    ju = jax.tree_util.tree_leaves(junpack(jpacked))
    pu = jax.tree_util.tree_leaves(unpack(packed))
    for got, ref in zip(pu, ju):
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(ref, np.float32))


# bf16 weights and activations over 2 layers: 2^-8 a rounding, a few
# dozen of them along a logit's path, so 2e-2 of the largest logit
BF16_LOGIT_TOL = 2e-2


def test_int8_first_logits_match_jax(jax_params, port_params):
    """The int8 engines' first prefill logits (bf16 compute on the same
    dequantized weights) agree to ``BF16_LOGIT_TOL`` of the largest;
    the int8 engine's to its own bf16 engine's likewise."""
    jeng = JaxEngine(jax_params, JaxConfig(**DIMS, causal=True,
                                           attn_impl="fast"),
                     cache=JaxCache(**CACHE), olevel="int8", decode_width=4)
    peng = _port_engine(port_params, olevel="int8")
    beng = _port_engine(port_params, olevel="bf16")
    assert peng.compression_ratio == pytest.approx(jeng.compression_ratio)
    tokens = np.zeros(CACHE["max_ctx"], np.int32)
    tokens[:9] = np.arange(1, 10)
    _, jlast = jeng.prefill(tokens, 9, np.array([1, 2, 0, 0], np.int32),
                            seed=0)
    _, plast = peng.prefill(tokens, 9, np.array([1, 2, 0, 0]), seed=0)
    _, blast = beng.prefill(tokens, 9, np.array([1, 2, 0, 0]), seed=0)
    ref = np.asarray(jlast, np.float32)
    scale = np.abs(ref).max()
    assert np.abs(plast.float().numpy() - ref).max() <= BF16_LOGIT_TOL * scale
    assert np.abs(plast.float().numpy() - blast.float().numpy()).max() \
        <= BF16_LOGIT_TOL * scale


def test_int8_batcher_serves_and_ledgers_the_ratio(port_params):
    """Six requests through the int8 engine: all done, the ledger valid
    with its compression ratio."""
    eng = _port_engine(port_params, olevel="int8")
    bat = ContinuousBatcher(eng)
    for spec in _specs():
        bat.submit(Request(**spec))
    results = bat.run()
    assert all(r.status == "done" for r in results.values())
    doc = bat.ledger.snapshot(olevel="int8", decode_width=4,
                              compression_ratio=eng.compression_ratio)
    assert doc["compression_ratio"] > 3.5
    assert serve_violations(doc) == []


def test_greedy_ties_go_to_first_index():
    logits = torch.tensor([1.0, 3.0, 3.0, 0.0])
    assert int(sample_token(logits, 0, 0.0, 0)) == 1


def test_top_k_keeps_ties_and_sampling_is_keyed():
    logits = torch.tensor([5.0, 4.0, 4.0, 4.0, -3.0])
    seen = {int(sample_token(logits, request_key(s, 3), 5.0, 2))
            for s in range(200)}
    assert seen <= {0, 1, 2, 3} and {1, 2, 3} <= seen
    a = int(sample_token(logits, request_key(7, 3), 5.0, 0))
    assert a == int(sample_token(logits, request_key(7, 3), 5.0, 0))
    assert request_key(7, 3) != request_key(7, 4) != request_key(8, 3)


def _telemetry_run(bat_cls, req_cls, engine, rmod, tmod, specs):
    sink = rmod.MemorySink()
    reg = rmod.Registry(sink=sink, rank0_only=False, flush_interval=0,
                        **({"memory": False, "goodput": False,
                            "exporter": False} if rmod is port_registry
                           else {}))
    tracer = tmod.Tracer(enabled=True)
    bat = bat_cls(engine, registry=reg, tracer=tracer)
    for spec in specs:
        bat.submit(req_cls(**spec))
    res = bat.run()
    reg.flush()
    events = [(r["name"], r["fields"].get("rid"))
              for r in sink.records if r["kind"] == "event"]
    gauges = {r["name"] for r in sink.records
              if r["kind"] == "metric" and r["type"] == "gauge"}
    spans = [e["name"] for e in tracer.export()["traceEvents"]
             if e.get("ph") == "X"]
    return res, events, gauges, spans, sink.records, bat


@pytest.mark.parametrize("flood", [False, True], ids=["plain", "flood"])
def test_batcher_telemetry_matches_jax(jax_params, port_params, flood):
    specs = _specs(seed=4)
    plans = [None, None]
    if flood:
        plans = [jax_faults.parse("request_flood@2:3"),
                 port_faults.parse("request_flood@2:3")]
    prev = (jax_faults.install(plans[0]), port_faults.install(plans[1]))
    try:
        jres, jev, jg, jspans, _, _ = _telemetry_run(
            JaxBatcher, JaxRequest, _jax_engine(jax_params), jax_registry,
            jax_trace, specs)
        pres, pev, pg, pspans, precs, pbat = _telemetry_run(
            ContinuousBatcher, Request, _port_engine(port_params),
            port_registry, port_trace, specs)
    finally:
        jax_faults.install(prev[0])
        port_faults.install(prev[1])
    assert pev == jev
    assert {n for n, _ in pev} >= {"serve.submit", "serve.admit",
                                   "serve.finish"}
    assert ("serve.request_flood", None) in pev if flood else True
    assert len(pres) == len(jres) == len(specs) + (3 if flood else 0)
    assert all(r.status == "done" for r in pres.values())
    assert pg == jg and "serve.p99_ms" in pg
    assert sorted(pspans) == sorted(jspans)
    assert pspans.count("serve.prefill") == len(pres)
    assert jax_registry.records_violations(precs) == []
    doc = pbat.ledger.snapshot(olevel="fp32", decode_width=4)
    assert serve_violations(doc) == []


def test_serve_ledger_cli_renders_the_port_artifact(port_params, tmp_path,
                                                    capsys):
    bat = ContinuousBatcher(_port_engine(port_params))
    for spec in _specs(seed=2):
        bat.submit(Request(**spec))
    bat.run()
    path = bat.ledger.write(directory=str(tmp_path), olevel="fp32",
                            decode_width=4)
    assert port_serve_ledger.cli([path]) == 0
    assert "served" in capsys.readouterr().out
    assert port_serve_ledger.cli([str(tmp_path)]) == 0
    capsys.readouterr()
    assert port_serve_ledger.cli([str(tmp_path / "none")]) == 1
