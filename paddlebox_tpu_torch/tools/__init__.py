"""Command-line tools over the port's telemetry, run as
``python -m paddlebox_tpu_torch.tools.<name>``: ``telemetry_report``
renders a run's JSONL event stream, ``obs_check`` is the black-box
observability gate."""
