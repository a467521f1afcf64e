"""Command-line tools of the port, run as ``python -m
paddlebox_tpu_torch.tools.<name>``: ``telemetry_report`` renders a run's
JSONL event stream, ``onlinelearn`` launches the online daemon, and the
gates ``obs_check`` (black-box observability), ``online_check`` (the
daemon's soak and chaos legs), ``stream_check``, ``preempt_check``,
``publish_check`` and ``serve_check``."""
