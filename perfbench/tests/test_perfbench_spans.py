"""Device time by program span (``lib/spans.py``), on traces written by
hand: each device operation's owner by the rule the module states, the
owners summing to the window's device time, the six span metrics'
subtrees, ``reduce_events`` unchanged but for ``span_s``; and on the
card, a small BERT step under O5 whose unattributed share is under 2 %."""
import pytest
import torch

from perfbench.lib import harness, readers, spans, trace
from perfbench.span_report import report
from perfbench.tests.test_perfbench_trace import _events, _reduce
from perfbench.tests.tiny import ROOT

NAMES = ("train.forward", "train.backward", "model.embed", "model.attention",
         "attention.core", "model.mlp", "model.head", "model.loss",
         "amp.step", "amp.optimizer")
MAIN, AUTOGRAD, STREAM = 1, 2, 7
METRICS = ("embed_ms.bert", "attention_ms.bert", "mlp_ms.bert",
           "head_loss_ms.bert", "amp_update_ms.bert", "unattributed_ms.bert")


def _x(cat, name, ts, dur, tid=MAIN, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": float(ts),
            "dur": float(dur), "pid": 1, "tid": tid, "args": args}


def _launch(ts, corr, tid=MAIN):
    return _x("cuda_runtime", "cudaLaunchKernel", ts, 1, tid,
              correlation=corr)


def _kernel(name, ts, dur, corr, cat="kernel"):
    e = _x(cat, name, ts, dur, STREAM, correlation=corr)
    e["pid"] = 0
    return e


def _bwd(name, ts, dur, seq, tid):
    return _x("cpu_op", "autograd::engine::evaluate_function: " + name, ts,
              dur, tid, **{"Sequence number": seq, "Fwd thread id": 1})


def _trace():
    """One step: a forward with nested spans, a backward on the autograd
    thread (its rows linked to forward ops by number), a backward row on
    the caller's thread, amp's update, launches outside every span and a
    fill with no launch."""
    return [
        _x("user_annotation", trace.WINDOW, 0, 3000),
        _x("user_annotation", "train.forward", 100, 300),
        _x("user_annotation", "model.embed", 105, 4),
        _x("cpu_op", "aten::unbind", 106, 2, **{"Sequence number": 3}),
        _x("user_annotation", "model.attention", 110, 100),
        _x("user_annotation", "attention.core", 120, 40),
        _x("cpu_op", "aten::mm", 125, 15, **{"Sequence number": 7}),
        _launch(130, 1),
        _launch(170, 2),
        _x("user_annotation", "model.loss", 300, 50),
        _x("cpu_op", "aten::mul", 305, 5, **{"Sequence number": 9}),
        _x("cpu_op", "aten::add", 380, 5, **{"Sequence number": 11}),
        _launch(410, 4),                       # between the spans
        _x("user_annotation", "train.backward", 420, 600),
        _bwd("MmBackward0", 450, 30, 7, AUTOGRAD),
        _launch(460, 3, AUTOGRAD),
        _bwd("UnbindBackward0", 490, 20, 3, AUTOGRAD),
        _launch(495, 8, AUTOGRAD),
        _bwd("AddBackward0", 520, 20, 11, AUTOGRAD),   # no span around
        _launch(525, 9, AUTOGRAD),
        _bwd("MulBackward0", 550, 20, 9, MAIN),        # the caller's
        _launch(555, 10, MAIN),
        _bwd("CopyBackwards", 580, 20, 99, MAIN),      # no forward op
        _launch(585, 11, MAIN),
        _bwd("CopyBackwards", 610, 20, 98, AUTOGRAD),
        _launch(615, 12, AUTOGRAD),
        _x("user_annotation", "amp.step", 1100, 200),
        _x("user_annotation", "amp.optimizer", 1150, 100),
        _launch(1160, 5),
        _launch(1190, 6),
        _kernel("attn_core", 200, 50, 1),
        _kernel("attn_proj", 250, 20, 2),
        _kernel("glue", 420, 5, 4),
        _kernel("attn_core_bwd", 500, 80, 3),
        _kernel("stack", 580, 40, 8),
        _kernel("add_bwd", 620, 3, 9),
        _kernel("loss_bwd", 630, 7, 10),
        _kernel("copy_b", 640, 2, 11),
        _kernel("copy_a", 650, 2, 12),
        _kernel("lamb", 1200, 60, 5),
        _kernel("Memset", 1270, 4, 6, cat="gpu_memset"),
        _kernel("Memcpy", 1280, 6, 77, cat="gpu_memcpy"),   # no launch
        _kernel("before", -50, 10, 1),                      # not in window
    ]


WANT = {
    "attn_core": ("train.forward/model.attention/attention.core", False),
    "attn_proj": ("train.forward/model.attention", False),
    "glue": (spans.UNATTRIBUTED, False),
    "attn_core_bwd": ("train.forward/model.attention/attention.core", True),
    "stack": ("train.forward/model.embed", True),
    "add_bwd": ("train.forward", True),
    "loss_bwd": ("train.forward/model.loss", True),
    "copy_b": ("train.backward", True),
    "copy_a": (spans.UNATTRIBUTED, True),
    "lamb": ("amp.step/amp.optimizer", False),
    "Memset": ("amp.step/amp.optimizer", False),
    "Memcpy": (spans.UNATTRIBUTED, False),
}


def test_each_device_operation_has_the_owner_the_rule_gives():
    got = {e["name"]: (path, bwd)
           for e, path, bwd in spans.attribute(_trace(), NAMES)}
    assert got == WANT


def test_owners_sum_to_the_window_device_time():
    events = _trace()
    s = spans.span_seconds(events, NAMES)
    device = sum(e["dur"] for e in events if e["cat"] in trace.DEVICE_CATS
                 and 0 <= e["ts"] < 3000)
    assert sum(s.values()) == pytest.approx(device * 1e-6)
    assert s["train.forward/model.attention/attention.core"] == \
        pytest.approx(130e-6)
    assert s[spans.UNATTRIBUTED] == pytest.approx(13e-6)


def test_a_remat_recompute_is_owned_by_its_own_spans():
    """Spans reopened inside a backward row (a recompute) own what is
    launched there, on the autograd thread or the caller's."""
    for tid, outer in ((AUTOGRAD, []), (MAIN, [
            _x("user_annotation", "train.backward", 0, 1000)])):
        events = outer + [
            _x("user_annotation", trace.WINDOW, 0, 1000),
            _bwd("CheckpointFunctionBackward", 10, 500, 1, tid),
            _x("user_annotation", "model.attention", 20, 100, tid),
            _x("user_annotation", "attention.core", 30, 50, tid),
            _launch(40, 1, tid),
            _kernel("recompute", 100, 10, 1)]
        [(_, path, bwd)] = spans.attribute(events, NAMES)
        assert (path, bwd) == ("model.attention/attention.core", False)


def test_metrics_read_their_subtrees_and_sum_to_device_time():
    s = spans.span_seconds(_trace(), NAMES)
    rec = {"trace": {"steps": 2, "span_s": s}}
    got = {m: harness.load_module(ROOT / "perfbench" / "metrics" / f"{m}.py",
                                  "span_metric_" + m.replace(".", "_"))
           .read(rec) for m in METRICS}
    assert got == pytest.approx({
        "embed_ms.bert": 0.020, "attention_ms.bert": 0.075,
        "mlp_ms.bert": 0.0, "head_loss_ms.bert": 0.0035,
        "amp_update_ms.bert": 0.032, "unattributed_ms.bert": 0.009})
    assert sum(got.values()) == pytest.approx(1e3 * sum(s.values()) / 2)
    assert spans.subtree("train.forward/model.head") == "head_loss"
    assert spans.subtree("train.backward") == spans.UNATTRIBUTED


def test_reduce_events_unchanged_but_for_span_s():
    """On the trace tests' fixture: every key the parent's reduction
    returned, as it returned it, and ``span_s`` beside them."""
    assert trace.reduce_events.plain is not None
    hooked = _reduce()
    names = {"flash_fwd_sm90_kernel": "flash_fwd"}

    def launch(k):
        return next((v for f, v in names.items() if f in k), None)
    plain = trace.reduce_events.plain(_events(), 2, {"flash_fwd": 1},
                                      launch,
                                      lambda k: launch(k) is not None)
    assert set(hooked) == set(plain) | {"span_s"}
    assert {k: v for k, v in hooked.items() if k != "span_s"} == plain
    # the fixture holds no step span: everything is unattributed
    assert hooked["span_s"] == {spans.UNATTRIBUTED: pytest.approx(260e-6)}


def test_a_program_without_step_spans_reads_nothing(monkeypatch):
    monkeypatch.setattr(spans, "step_spans", lambda: None)
    r = _reduce()
    assert "span_s" not in r
    assert spans.ms_per_step({"trace": r}, "attention") is None
    assert readers.amp_step_ms({"trace": r}) is not None


def test_report_splits_forward_and_backward_and_names_gaps():
    out = report(_trace(), 1, NAMES)
    core = out["by_owner"]["train.forward/model.attention/attention.core"]
    assert core["forward_ms"] == pytest.approx(0.05)
    assert core["backward_ms"] == pytest.approx(0.08)
    # named by the op that launched it and, in the backward, its node
    assert core["top"] == [["MmBackward0: attn_core_bwd", pytest.approx(0.08)],
                           ["aten::mm: attn_core", pytest.approx(0.05)]]
    assert out["by_owner"][spans.UNATTRIBUTED]["top"][0] == [
        "Memcpy", pytest.approx(0.006)]
    assert out["spans_per_step"] == 8
    assert out["device_ms_per_step"] == pytest.approx(0.279)
    assert sum(out["by_metric"].values()) == pytest.approx(0.279)
    # the widest gap, 1286-3000 us, falls after amp's update; the next,
    # 652-1200 us, has its middle in train.backward
    assert out["idle_gaps"][0]["spans"] == "none"
    assert out["idle_gaps"][1]["spans"] == "train.backward"


@pytest.mark.cuda
def test_bert_step_on_the_card_leaves_under_2pct_unattributed():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from apex_tpu_torch import amp
    from apex_tpu_torch.models.transformer import (TransformerConfig,
                                                   transformer_init)
    from apex_tpu_torch.optimizers import FusedLAMB
    from apex_tpu_torch.train import train_step
    dev = torch.device("cuda", 0)
    cfg = TransformerConfig(vocab_size=4096, max_len=256, num_layers=4,
                            d_model=512, num_heads=8, d_ff=2048,
                            dropout=0.1, dtype=torch.bfloat16,
                            attn_impl="fast", xent_impl="pallas")
    state = {"amp": amp.initialize(
        transformer_init(cfg, torch.Generator().manual_seed(3), device=dev),
        FusedLAMB(lr=1e-3, max_grad_norm=1.0, impl="fused"),
        opt_level="O5", verbosity=0)}
    batch = {"tokens": torch.randint(0, 4096, (16, 256), device=dev),
             "targets": torch.randint(0, 4096, (16, 256), device=dev),
             "weights": (torch.rand(16, 256, device=dev) < 0.15).float()}
    drop = torch.Generator().manual_seed(4)

    def step():
        state["amp"], _ = train_step(state["amp"], batch, cfg,
                                     dropout_rng=drop)
    step()
    t = trace.traced_window(step, 2.0, 4)
    total = sum(t["span_s"].values())
    rest = sum(v for p, v in t["span_s"].items()
               if spans.subtree(p) == spans.UNATTRIBUTED)
    assert rest < 0.02 * total, t["span_s"]
    for name, _ in spans.SUBTREES:
        assert any(spans.subtree(p) == name for p in t["span_s"]), name
