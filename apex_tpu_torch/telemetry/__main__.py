"""``python -m apex_tpu_torch.telemetry``: render a run's JSONL (or run the
instrumented-transformer demo) into the step-metrics summary; ``trace
<file>`` renders the span summary of a Chrome trace, ``goodput
<jsonl|run-dir|GOODPUT.json>`` the run's goodput ledger, ``mem
<flight-oom-*.json>`` an OOM post-mortem, ``serve <SERVE.json|run-dir>``
the per-request serving ledger.  See ``report.main`` for the flags."""
from .report import main

if __name__ == "__main__":
    raise SystemExit(main())
