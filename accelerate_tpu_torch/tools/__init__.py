"""The reference's serving forensics tools, ported over the port's own trace,
journal, telemetry and metrics modules. Each runs as
``python -m accelerate_tpu_torch.tools.<name>`` with the reference tool's
arguments, output and exit codes (0 clean, 1 anomaly, 2 unreadable):
``journal_fsck``, ``trace_report``, ``explain_request``, ``serve_top`` and
``check_metrics_docs``."""
