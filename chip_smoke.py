#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``apex_tpu_torch``) on one
NVIDIA GPU.

    python3 chip_smoke.py             # the whole smoke, one card
    python3 chip_smoke.py --profile   # also: torch.profiler over one
                                      # prefill + decode steps of the main path
                                      # (full table: build/profile_serve.txt)

Phases, in order; any failure exits nonzero and prints no result line:

1. environment: torch/CUDA versions and the card's name and power limit
   (``nvidia-smi``); TF32 off for matmuls and cuDNN;
2. build: the CUDA kernels from ``apex_tpu_torch/csrc`` into ``build/``;
3. each kernel against its plain PyTorch version on the card, at the
   serving shapes, with its device time (a CUDA graph of 20 calls replayed
   between CUDA events, median of 10 replays), the time of one call with
   its host cost (CUDA events around the call, median of 30), the plain
   version's and one PyTorch library call's device time (the library call
   is a yardstick the port never calls) and the least time the card could
   take;
4. serve parity: a 2-layer engine at BERT-large width, fp32, on the card
   and on the CPU with the same weights — prefill logits within 1e-3 and
   the same greedy tokens over 8 decode steps;
5. the main path: a 24-layer BERT-large-width engine, bf16, ``attn_impl=
   "fast"``, random weights from a seed, serving a seeded trace of 16
   requests through ``ContinuousBatcher.run()``, with every kernel's launch
   count read around that run;
6. one ``{"kernels": [...]}`` line;
7. last line ``{"ok": true, "device": {...}}``.

Tolerances: an element passes when ``|kernel - plain| <= tol *
max(1, |plain|)``, with tol = 1e-5 (layer norm, fp32), 1e-4 (flash, fp32),
2e-2 (bf16: the two versions may round one value to neighbouring bf16
numbers, 2^-8 apart relative to the value).  ``mean`` is held to 1e-5 and
``invvar`` and the live rows' ``lse`` to 1e-4 relative; dead rows' lse must
be exactly +1e30.  ``max_abs_err`` reports the plain absolute difference.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

# peak rates of one H100 SXM (NVIDIA data sheet, dense)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}

LN_REPLACES = "apex_tpu/ops/layer_norm.py:52"
FLASH_REPLACES = "apex_tpu/contrib/multihead_attn/flash.py:276"


def log(msg: str) -> None:
    print(msg, flush=True)


class SmokeFailure(RuntimeError):
    pass


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


# ---------------------------------------------------------------------------
# timing and bounds
# ---------------------------------------------------------------------------

def time_ms(fn, reps: int = 30, warmup: int = 5) -> float:
    """Median of ``reps`` launches, each between two CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def device_ms(fn, n: int = 20, reps: int = 10) -> float:
    """Device time of one call: ``n`` calls captured in a CUDA graph, the
    graph replayed between two CUDA events, median over ``reps`` replays,
    divided by ``n`` — the host's launch cost is left out."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / n)
    del graph
    return statistics.median(times)


def bound(bytes_moved: float, flops: float, dtype: str):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def scaled_ok(got, ref, tol: float):
    """(all elements within tol * max(1, |ref|), max absolute error)."""
    err = (got.float() - ref.float()).abs()
    ok = bool((err <= tol * ref.float().abs().clamp(min=1.0)).all())
    return ok, float(err.max())


def rel_err(got, ref) -> float:
    return float(((got - ref).abs() / ref.abs().clamp(min=1.0)).max())


# ---------------------------------------------------------------------------
# phase 1: environment
# ---------------------------------------------------------------------------

def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0].strip()


def phase_environment():
    import torch
    log("== phase 1: environment")
    log(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
        f"cuda {torch.version.cuda}  devices {torch.cuda.device_count()}")
    card = card_line()
    log(f"card: {card}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return card


# ---------------------------------------------------------------------------
# phase 2: build
# ---------------------------------------------------------------------------

def phase_build():
    from apex_tpu_torch.utils import build
    log("== phase 2: build")
    res = build.build()
    for line in res.log.splitlines():
        if "registers" in line or "spill" in line or line.startswith("=="):
            log(f"  ptxas: {line.strip()}")
    build.library()
    log(f"built {res.path.relative_to(HERE)} in {res.seconds:.1f} s "
        f"(cached: {res.cached})")


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def _randn(shape, gen, dtype, dev, scale=1.0, shift=0.0):
    import torch
    return (torch.randn(shape, generator=gen) * scale + shift).to(dev, dtype)


def check_layer_norm(dev):
    import torch
    import torch.nn.functional as F
    from apex_tpu_torch.ops.layer_norm import ln_fwd, ln_fwd_reference
    rows = []
    gen = torch.Generator().manual_seed(0)
    for n, h in ((512, 1024), (8, 1024)):
        for dtype in ("bfloat16", "float32"):
            for affine in (True, False):
                dt = getattr(torch, dtype)
                x = _randn((n, h), gen, dt, dev, 2.0, 0.5)
                w = _randn((h,), gen, dt, dev) if affine else None
                b = _randn((h,), gen, dt, dev) if affine else None
                out, mean, inv = ln_fwd(x, w, b, 1e-5)
                torch.cuda.synchronize()
                r_out, r_mean, r_inv = ln_fwd_reference(x, w, b, 1e-5)
                tol = 1e-5 if dtype == "float32" else 2e-2
                ok, err = scaled_ok(out, r_out, tol)
                m_err = float((mean - r_mean).abs().max())
                i_err = rel_err(inv, r_inv)
                require(ok and m_err <= 1e-5 and i_err <= 1e-4,
                        f"ln_fwd ({n},{h}) {dtype} affine={affine}: out err "
                        f"{err:.3g} (tol {tol}), mean {m_err:.3g}, invvar "
                        f"{i_err:.3g}")
                es = x.element_size()
                nbytes = 2 * n * h * es + 2 * n * 4 + (2 * h * es if affine
                                                       else 0)
                bms, by = bound(nbytes, 8.0 * n * h, "float32")
                ms = device_ms(lambda: ln_fwd(x, w, b, 1e-5))
                call_ms = time_ms(lambda: ln_fwd(x, w, b, 1e-5))
                pms = device_ms(lambda: ln_fwd_reference(x, w, b, 1e-5))
                lms = device_ms(lambda: F.layer_norm(x, (h,), w, b, 1e-5))
                l_call = time_ms(lambda: F.layer_norm(x, (h,), w, b, 1e-5))
                row = dict(shape=(n, h), dtype=dtype, affine=affine,
                           max_abs_err=err, tol=tol, mean_err=m_err,
                           invvar_rel_err=i_err, ms=ms, call_ms=call_ms,
                           plain_ms=pms, library_ms=lms, bound_ms=bms,
                           bound_by=by)
                rows.append(row)
                log(f"  ln_fwd ({n},{h}) {dtype:8s} affine={affine!s:5s} "
                    f"out err {err:.3g} (tol {tol}) mean {m_err:.2g} "
                    f"invvar {i_err:.2g} | kernel {ms:.5f} ms (one call "
                    f"with its host cost {call_ms:.4f} ms)  plain {pms:.5f} "
                    f"ms  F.layer_norm {lms:.5f} ms (one call {l_call:.4f} "
                    f"ms)  bound {bms:.5f} ms ({by})")
    return rows


def _flash_inputs(B, heads, sq, sk, d, kind, gen, dt, dev):
    import torch
    bh = B * heads
    q = _randn((bh, sq, d), gen, dt, dev, 1.0 / d ** 0.5)
    k = _randn((bh, sk, d), gen, dt, dev)
    v = _randn((bh, sk, d), gen, dt, dev)
    if kind == "zeros":
        bias = torch.zeros((1, 1, sk))
    else:   # key padding per batch row plus one dead query row
        bias = torch.zeros((B, sq, sk))
        for b_ in range(B):
            bias[b_, :, sk - 7 - 5 * b_:] = -1e9
        bias[B - 1, sq // 2, :] = -1e30
    return q, k, v, bias.to(dev)


def check_flash(dev):
    import torch
    import torch.nn.functional as F
    from apex_tpu_torch.contrib.multihead_attn.flash import (_flash_fwd,
                                                             _reference)
    rows = []
    gen = torch.Generator().manual_seed(1)
    cases = [  # name, B, heads, Sq, Sk, D, bias, causal, dropout
        ("serving", 1, 16, 512, 512, 64, "zeros", True, 0.0),
        ("ragged_pad_dead", 2, 4, 200, 333, 64, "pad_dead", False, 0.0),
        ("dropout", 1, 16, 512, 512, 64, "zeros", True, 0.1),
        ("d128", 2, 2, 130, 130, 128, "zeros", True, 0.0),
        ("d32", 2, 2, 96, 160, 32, "pad_dead", False, 0.1),
    ]
    for name, B, heads, sq, sk, d, kind, causal, rate in cases:
        for dtype in ("bfloat16", "float32"):
            dt = getattr(torch, dtype)
            q, k, v, bias = _flash_inputs(B, heads, sq, sk, d, kind, gen, dt,
                                          dev)
            out, lse = _flash_fwd(q, k, v, bias, causal, rate, 1234, heads)
            torch.cuda.synchronize()
            r_out, r_lse = _reference(q, k, v, bias, causal, rate, 1234,
                                      heads)
            tol = 1e-4 if dtype == "float32" else 2e-2
            ok, err = scaled_ok(out, r_out, tol)
            live = r_lse < 1e29
            l_err = rel_err(lse[live], r_lse[live])
            dead_ok = bool((lse[~live] == r_lse[~live]).all()) and bool(
                (out[(~live)[..., 0]] == 0).all())
            n_dead = int((~live).sum())
            require(ok and l_err <= 1e-4 and dead_ok,
                    f"flash {name} {dtype}: out err {err:.3g} (tol {tol}), "
                    f"lse rel err {l_err:.3g}, dead rows ok {dead_ok}")
            bh = B * heads
            es = q.element_size()
            nbytes = (2 * bh * sq * d + 2 * bh * sk * d) * es \
                + bias.numel() * 4 + bh * sq * 4
            pairs = (sum(min(r + 1, sk) for r in range(sq)) if causal
                     else sq * sk)
            bms, by = bound(nbytes, 4.0 * d * pairs * bh, dtype)
            ms = device_ms(lambda: _flash_fwd(q, k, v, bias, causal, rate,
                                              1234, heads))
            call_ms = time_ms(lambda: _flash_fwd(q, k, v, bias, causal,
                                                 rate, 1234, heads))
            pms = device_ms(lambda: _reference(q, k, v, bias, causal, rate,
                                               1234, heads), n=5)
            lms = l_call = None
            if name == "serving":
                q4, k4, v4 = (t.view(B, heads, -1, d) for t in (q, k, v))

                def sdpa():
                    return F.scaled_dot_product_attention(
                        q4, k4, v4, is_causal=True, scale=1.0)
                lms, l_call = device_ms(sdpa), time_ms(sdpa)
            rows.append(dict(case=name, dtype=dtype, max_abs_err=err,
                             tol=tol, lse_rel_err=l_err, dead_rows=n_dead,
                             ms=ms, call_ms=call_ms, plain_ms=pms,
                             library_ms=lms, bound_ms=bms, bound_by=by))
            lib = (f"{lms:.5f} ms (one call {l_call:.4f} ms)"
                   if lms is not None else "n/a")
            log(f"  flash {name:15s} {dtype:8s} out err {err:.3g} (tol "
                f"{tol}) lse {l_err:.2g} dead rows {n_dead} | kernel "
                f"{ms:.5f} ms (one call with its host cost {call_ms:.4f} "
                f"ms)  plain {pms:.5f} ms  sdpa {lib}  bound {bms:.5f} ms "
                f"({by})")
    return rows


# ---------------------------------------------------------------------------
# phase 4: serve parity, card vs CPU
# ---------------------------------------------------------------------------

def phase_serve_parity(dev):
    import torch
    from apex_tpu_torch.models import bert_large_config, transformer_init
    from apex_tpu_torch.serve import CacheConfig, InferenceEngine
    log("== phase 4: serve parity (2 layers, BERT-large width, fp32, card "
        "vs CPU)")
    cfg = bert_large_config(num_layers=2, causal=True, attn_impl="fast")
    params = transformer_init(cfg, torch.Generator().manual_seed(0),
                              device="cpu")
    cache = CacheConfig(page_size=16, num_pages=40, max_ctx=512)
    W = 8
    engines = [InferenceEngine(params, cfg, cache=cache, olevel="fp32",
                               decode_width=W, device=d)
               for d in (dev, "cpu")]
    rng = np.random.default_rng(4)
    plen = 300
    tokens = np.zeros(cache.max_ctx, np.int64)
    tokens[:plen] = rng.integers(1, cfg.vocab_size, plen)
    table = np.zeros(cache.pages_per_request, np.int64)
    table[:32] = np.arange(1, 33)
    (g_first, g_last), (c_first, c_last) = (
        e.prefill(tokens, plen, table, seed=0) for e in engines)
    err = float((g_last.cpu() - c_last).abs().max())
    require(err <= 1e-3, f"prefill last-row logits differ by {err:.3g}")
    require(int(g_first) == int(c_first), "prefill greedy tokens differ")
    log(f"  prefill last-row logits max abs diff {err:.3g} (tol 1e-3)")
    cur = np.zeros(W, np.int64)
    pos = np.zeros(W, np.int64)
    tables = np.zeros((W, cache.pages_per_request), np.int64)
    cur[0], pos[0], tables[0] = int(g_first), plen, table
    zeros = np.zeros(W, np.int64)
    temps = np.zeros(W, np.float32)
    g_toks, c_toks, d_err = [], [], 0.0
    for _ in range(8):
        (gt, gl), (ct, cl) = (e.decode_step(cur, pos, tables, zeros, temps,
                                            zeros) for e in engines)
        d_err = max(d_err, float((gl[0].cpu() - cl[0]).abs().max()))
        g_toks.append(int(gt[0]))
        c_toks.append(int(ct[0]))
        cur[0], pos[0] = g_toks[-1], pos[0] + 1
    require(g_toks == c_toks, f"greedy decode tokens differ: card {g_toks} "
            f"cpu {c_toks}")
    require(d_err <= 1e-3, f"decode logits differ by {d_err:.3g}")
    log(f"  8 greedy decode tokens identical {g_toks}; decode logits max abs "
        f"diff {d_err:.3g} (tol 1e-3)")


# ---------------------------------------------------------------------------
# phase 5: the main path
# ---------------------------------------------------------------------------

def _trace(cfg, n=16, seed=0):
    """The bench's serve mix at full width: prompts 32-448 tokens, 16-32 new
    tokens, half greedy, half temperature 0.8 with top-k 8."""
    from apex_tpu_torch.serve import Request
    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(n):
        plen = int(rng.integers(32, 449))
        reqs.append(Request(
            rid=f"q{i}",
            prompt=rng.integers(1, cfg.vocab_size, plen).tolist(),
            max_new_tokens=int(rng.integers(16, 33)),
            temperature=0.8 if i % 2 else 0.0, top_k=8 if i % 2 else 0,
            seed=i))
    return reqs


def phase_main_path(dev, card, profile=False):
    import torch
    from apex_tpu_torch.models import bert_large_config, transformer_init
    from apex_tpu_torch.serve import (CacheConfig, ContinuousBatcher,
                                      InferenceEngine, Request)
    from apex_tpu_torch.telemetry.serve_ledger import serve_violations
    from apex_tpu_torch.utils import build
    log("== phase 5: main path (BERT-large width, 24 layers, bf16, fast "
        "attention, 16-request trace)")
    cfg = bert_large_config(causal=True, attn_impl="fast")
    t0 = time.perf_counter()
    params = transformer_init(cfg, torch.Generator().manual_seed(0),
                              device=dev)
    cache = CacheConfig(page_size=16, num_pages=257, max_ctx=512)
    eng = InferenceEngine(params, cfg, cache=cache, olevel="bf16",
                          decode_width=8, device=dev)
    del params
    torch.cuda.synchronize()
    log(f"  weights from seed 0 + engine on the card in "
        f"{time.perf_counter() - t0:.1f} s")

    warm = ContinuousBatcher(eng)           # warm-up outside the counts
    for i in range(2):
        warm.submit(Request(rid=f"w{i}", prompt=[5 + i] * (40 + i),
                            max_new_tokens=4, seed=100 + i))
    warm.run()
    torch.cuda.synchronize()

    reqs = _trace(cfg)
    bat = ContinuousBatcher(eng)
    for r in reqs:
        bat.submit(r)
    p0, d0 = eng.prefills, eng.decode_steps
    build.LAUNCHES.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = bat.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(build.LAUNCHES)
    prefills, decodes = eng.prefills - p0, eng.decode_steps - d0

    require(len(results) == len(reqs) and all(
        r.status == "done" for r in results.values()),
        f"not every request done: "
        f"{ {k: v.status for k, v in results.items()} }")
    for r in reqs:
        toks = results[r.rid].tokens
        require(len(toks) == r.max_new_tokens and all(
            0 <= t < cfg.vocab_size for t in toks),
            f"{r.rid}: bad tokens {toks}")
    doc = bat.ledger.snapshot(olevel="bf16", decode_width=8)
    bad = serve_violations(doc)
    require(not bad, f"serve ledger violations: {bad}")
    L = cfg.num_layers
    require(prefills == len(reqs), f"{prefills} prefills for {len(reqs)} "
            "requests")
    require(launches.get("flash_fwd", 0) == L * prefills,
            f"flash_fwd launched {launches.get('flash_fwd', 0)} times, "
            f"expected {L} per prefill x {prefills}")
    require(launches.get("ln_fwd", 0) == (2 * L + 2) * (prefills + decodes),
            f"ln_fwd launched {launches.get('ln_fwd', 0)} times, expected "
            f"{2 * L + 2} per step x {prefills + decodes}")
    log(f"  {len(results)} requests done, {doc['tokens_out']} tokens, "
        f"{prefills} prefills, {decodes} decode steps, {bat.host_reads} host "
        f"reads; launches {launches}")
    lat = doc["latency_ms"]
    log(f"  [{card}] tokens/s {doc['tokens_per_sec']}  TTFT p50 "
        f"{lat['ttft_p50']} ms  latency p50 {lat['p50']} ms  p99 "
        f"{lat['p99']} ms  (trace wall {wall:.3f} s)")

    # step times, after the counted run: prefill of a 448-token prompt and
    # decode steps with all 8 slots active
    S, PPR = cache.max_ctx, cache.pages_per_request
    tokens = np.zeros(S, np.int64)
    tokens[:448] = np.arange(448) % (cfg.vocab_size - 1) + 1
    table = np.arange(1, PPR + 1)
    prefill_ms = time_ms(lambda: eng.prefill(tokens, 448, table, 0),
                         reps=10, warmup=2)
    W = eng.decode_width
    tables = np.tile(table, (W, 1))
    pos = np.full(W, 460)
    ones = np.ones(W, np.int64)
    temps = np.where(np.arange(W) % 2, 0.8, 0.0).astype(np.float32)
    topks = np.where(np.arange(W) % 2, 8, 0)
    decode_ms = time_ms(lambda: eng.decode_step(ones, pos, tables, ones,
                                                temps, topks),
                        reps=20, warmup=3)
    log(f"  [{card}] median prefill (448-token prompt) {prefill_ms:.3f} ms  "
        f"median decode step (8 slots) {decode_ms:.3f} ms")
    if profile:
        profile_steps(eng, tokens, table, ones, pos, tables, temps, topks)
    return launches, doc


def profile_steps(eng, tokens, table, toks, pos, tables, temps, topks):
    """torch.profiler over one prefill and 4 decode steps: device time by
    kernel and the device's busy share of the window (``--profile``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    out_dir = os.path.join(HERE, "build")
    os.makedirs(out_dir, exist_ok=True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.prefill(tokens, 448, table, 0)
        for _ in range(4):
            eng.decode_step(toks, pos, tables, toks, temps, topks)
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) * 1e3
    avgs = prof.key_averages()
    dev_us = sum(getattr(a, "self_device_time_total",
                         getattr(a, "self_cuda_time_total", 0)) for a in avgs)
    log(f"  profile: window {window_ms:.3f} ms, device busy "
        f"{dev_us / 1e3:.3f} ms ({100 * dev_us / 1e3 / window_ms:.1f}%)")
    table_txt = avgs.table(sort_by="self_cuda_time_total", row_limit=25)
    with open(os.path.join(out_dir, "profile_serve.txt"), "w") as f:
        f.write(table_txt)
    for line in table_txt.splitlines()[:30]:
        log(f"  {line}")


# ---------------------------------------------------------------------------

def main(argv) -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda is not available; this smoke needs an "
              "NVIDIA GPU", file=sys.stderr)
        return 2
    profile = "--profile" in argv
    dev = torch.device("cuda")
    t_start = time.perf_counter()
    card = phase_environment()
    phase_build()
    log("== phase 3: kernels vs plain versions on the card")
    ln_rows = check_layer_norm(dev)
    flash_rows = check_flash(dev)
    phase_serve_parity(dev)
    launches, _ = phase_main_path(dev, card, profile)

    ln_main = next(r for r in ln_rows if r["shape"] == (512, 1024)
                   and r["dtype"] == "bfloat16" and r["affine"])
    fl_main = next(r for r in flash_rows if r["case"] == "serving"
                   and r["dtype"] == "bfloat16")
    kernels = [
        dict(name="flash_fwd", route="cuda",
             source="apex_tpu_torch/csrc/flash_fwd.cu",
             replaces=FLASH_REPLACES, launches=launches["flash_fwd"],
             max_abs_err=fl_main["max_abs_err"], ms=fl_main["ms"],
             plain_ms=fl_main["plain_ms"], bound_ms=fl_main["bound_ms"],
             bound_by=fl_main["bound_by"], library_ms=fl_main["library_ms"]),
        dict(name="ln_fwd", route="cuda",
             source="apex_tpu_torch/csrc/layer_norm.cu",
             replaces=LN_REPLACES, launches=launches["ln_fwd"],
             max_abs_err=ln_main["max_abs_err"], ms=ln_main["ms"],
             plain_ms=ln_main["plain_ms"], bound_ms=ln_main["bound_ms"],
             bound_by=ln_main["bound_by"], library_ms=ln_main["library_ms"]),
    ]
    log(f"== done in {time.perf_counter() - t_start:.1f} s")
    print(card_line(), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
