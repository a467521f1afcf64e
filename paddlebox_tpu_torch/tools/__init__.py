"""Command-line tools of the port, run as ``python -m
paddlebox_tpu_torch.tools.<name>``: ``telemetry_report`` renders a run's
JSONL event stream, ``onlinelearn`` launches the online daemon, and the
gates ``obs_check`` (black-box observability), ``online_check`` (the
daemon's soak and chaos legs), ``stream_check``, ``preempt_check``,
``publish_check``, ``serve_check``, ``chaos_check`` (eight seeded fault
kinds in one run), ``pipeline_check`` (the pass pipeline against its
synchronous oracles) and ``ssd_check`` (the SSD tier against an
uncapped host tier)."""
