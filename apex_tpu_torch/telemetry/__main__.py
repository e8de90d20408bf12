"""``python -m apex_tpu_torch.telemetry``: render a run's JSONL (or run the
instrumented-transformer demo) into the step-metrics summary; ``trace
<file>`` renders the span summary of a Chrome trace, ``goodput
<jsonl|run-dir|GOODPUT.json>`` the run's goodput ledger, ``mem
[flight-oom-*.json]`` the demo step's peak-memory table or an OOM
post-mortem, ``serve <SERVE.json|run-dir>`` the per-request serving
ledger, ``timeline <trace|profiler-dir>`` the per-step device
decomposition, ``fleet <dir> [dir...]`` the merged fleet view.  See ``report.main`` for the flags."""
from .report import main

if __name__ == "__main__":
    raise SystemExit(main())
