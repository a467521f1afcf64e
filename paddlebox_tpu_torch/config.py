"""Process-wide flags of the port: those that the data pipeline, the
resident training pass, the table's shrink, the sharded table and step,
the resilience layer, checkpointing, streaming and serving's reload loop
read, and the telemetry, flight-recorder, quality and alert flags of the
observability layer (all off by default), with the names and defaults
of ``paddlebox_tpu/config.py``. ``FLAGS_<name>=...`` in the environment
overrides a default at import; tests change them with ``flags_scope``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
from typing import Any, Iterator


@dataclasses.dataclass
class Flags:
    # --- data pipeline (data/dataset.py) ---
    record_pool_max_size: int = 2_000_000
    read_thread_num: int = 8
    channel_capacity: int = 65536
    # native C++ file→columnar parse fast path (data/parser.py,
    # native/slot_parser.cpp); falls back to per-line python parsing
    native_parse: bool = True
    # max dataset files quarantined per load before the load fails
    # (0 = quarantine disabled: first bad file aborts, the seed behavior)
    poison_budget_files: int = 0
    # max dropped/corrupt records tolerated per FILE before the file is
    # declared poisoned and quarantined (-1 = unlimited silent drops,
    # the seed behavior)
    poison_budget_records: int = -1

    # --- streaming ingest (data/dataset.QueueDataset windowed mode +
    # Trainer.train_stream) ---
    # >0: QueueDataset consumes its filelist in bounded WINDOWS of N
    # files — no record crosses a window boundary, completed windows are
    # tracked per file, and the v2 stream cursor (cursor.json) records
    # fully-consumed files + the open window so a preempted streaming
    # job resumes by skipping completed files and replaying the open
    # window AT-LEAST-ONCE. 0 = legacy unwindowed streaming (no cursor
    # resume; start_batch != 0 keeps refusing).
    stream_window_files: int = 0
    # Trainer.train_stream publishes a stream-boundary checkpoint every
    # N completed windows (bounds replay after a hard kill)
    stream_ckpt_every_windows: int = 1

    # --- embedding store ---
    # default per-shard row capacity of ps/sharded.ShardedEmbeddingTable
    table_capacity_per_shard: int = 1 << 20
    # host-RAM backing store capacity (ps/host_store.HostStore; the rows
    # beyond the card's pass window)
    host_store_capacity: int = 1 << 24

    # --- the SSD tier (ps/ssd.SsdTier) ---
    # directory for segment files; non-empty attaches a tier to every
    # HostStore (one subdirectory each). "" = no tier unless a table
    # passes ssd_dir or spill_cold creates one next to its file.
    ssd_dir: str = ""
    # rows per append-only segment before it seals (sealed segments are
    # immutable: the manifest and compaction unit)
    ssd_segment_rows: int = 1 << 15
    # compaction rewrites a sealed segment whose live-row fraction falls
    # below this (<= 0 disables compaction)
    ssd_compact_live_frac: float = 0.5
    # host-RAM occupancy fraction above which the coldest rows demote to
    # the SSD tier (on the end-pass epilogue worker, after each
    # write-back); <= 0 disables it
    host_demote_watermark: float = 0.92
    # demotion drains RAM occupancy down to this fraction
    host_demote_target: float = 0.8

    # --- the pass window (ps/pass_table.py, ps/tiered.py) ---
    # end_pass gathers the touched rows on the training stream, copies
    # them to pinned host memory and hands the host-store write-back to
    # one background worker, so pass N+1 trains while pass N drains;
    # every host-tier read and lifecycle op fences first. False = write
    # back before end_pass returns (bit for bit the same model).
    async_end_pass: bool = True
    # with queued stages (train/device_pass.PassPipeline), the eviction
    # for the NEXT pass runs on the epilogue worker right after each
    # write-back lands (clean rows only: an index release, no device
    # read); begin_pass keeps the inline eviction as the emergency path.
    # False = eviction stays inline at begin_pass.
    async_capacity_evict: bool = True

    # --- the sharded step (train/sharded.py) ---
    # slot-group chunks of the sharded step's pull exchange: chunk g's
    # exchange, then its expand → pool. 1 = the monolithic schedule. >1
    # needs slot-qualified keys (each key in one slot group of its
    # batch); a plan that finds a key spanning groups falls back to the
    # monolithic layout for that batch, loudly. Both schedules give the
    # same bits.
    a2a_chunks: int = 1

    # route the resident pass's bulk row assignment
    # (``EmbeddingTable.bulk_assign_unique``) through the device key
    # index (``ops/index.py``): first-seen dedup and a linear-probe hash
    # insert on the card, the host kv mirrored with the NEW keys only.
    # Any state the device index cannot mirror exactly degrades, loudly
    # and for good, to the host index. Off = the host index. The sharded
    # table's per-shard row resolution (ps/sharded.py) rides it too.
    use_pallas_index: bool = False
    # whole-pass bulk key assignment: one index round trip per pass
    # instead of one per batch (False = the serial per-batch path)
    bulk_pass_assign: bool = True

    # --- the pass preload pipeline (train/device_pass.PassPreloader) ---
    # passes in flight (building or staged) ahead of training; 0 = one
    # build per start_next() call. The effective depth clamps under the
    # budget below.
    preload_depth: int = 2
    # staged-pass device memory budget: after each build the preloader
    # clamps its depth to max(1, budget // staged bytes of the pass),
    # loudly, and never raises it again (<= 0 disables the clamp; a
    # fraction of a MB is allowed)
    preload_hbm_budget_mb: float = 4096
    # build_streamed packs and copies the index blocks in chunks of this
    # many batches, each chunk's copy issued while later chunks pack
    # (<= 0 = the whole pass as one chunk)
    preload_pack_chunk_batches: int = 8
    # the q8 float wire on a non-columnar dataset that can be walked
    # twice: per-column min/max batch by batch, then a second walk casts
    # each batch to u8, without a whole-pass f32 block (and without
    # quantize_floats' winsorized range, so the two ship different bytes
    # for heavy-tailed columns). False = the whole-pass quantize_floats.
    # Kept for parity with the reference, which has the same switch.
    q8_streaming_front: bool = True
    # > 0: a pipeline wait that sees no build complete for this long
    # raises PipelineHangError (ps/epilogue.py) naming the stuck stage;
    # 0 = wait indefinitely
    pipeline_wait_timeout_sec: float = 0.0
    # EmbeddingTable.shrink: drop rows whose decayed show/clk score falls
    # below this, after decaying show/clk/delta_score by this rate
    shrink_delete_threshold: float = 0.0
    show_click_decay_rate: float = 0.98
    # online-learning daemon (online.OnlineLearner): a shrink cycle
    # every N completed stream windows; 0 = lifecycle aging off. Also
    # read by the alert engine's shrink_overdue rule
    # (obs/alerts.default_rules).
    shrink_every_windows: int = 0

    # --- resilience (resilience/) ---
    # RetryPolicy.from_flags defaults, applied at the IO seams
    retry_max_attempts: int = 4
    retry_base_delay_sec: float = 0.05
    retry_max_delay_sec: float = 2.0
    # wall-clock cap for one retried operation (<=0 = no deadline)
    retry_deadline_sec: float = 30.0
    # backoff jitter fraction in [0,1], seeded from the site name
    retry_jitter: float = 0.25
    # kill a hung CommandBackend CLI after this many seconds (<=0 = none)
    command_timeout_sec: float = 300.0
    # bounded retry-from-last-checkpoint attempts in Trainer.run_pass
    # (0 = a failed pass raises at once)
    pass_retry_limit: int = 0
    # fault-injection plan (resilience/faults.py grammar); "" = none
    fault_plan: str = ""
    # install SIGTERM/SIGINT -> graceful-stop handlers at Trainer init
    graceful_shutdown: bool = False
    # >0: an in-pass checkpoint (delta + cursor.json) every N batches,
    # so a preempted pass replays seconds, not the pass; needs
    # run_pass(checkpoint=...) and a dataset whose order is fixed
    ckpt_every_batches: int = 0

    # --- serving (serving.py) ---
    # ReloadLoop poll cadence while healthy (failed polls back off on the
    # seeded RetryPolicy schedule, site serving.reload)
    serving_reload_poll_sec: float = 2.0
    # a newer adoptable version unadopted for longer than this marks the
    # serving status stale
    serving_staleness_max_sec: float = 60.0

    # --- telemetry (obs/ TelemetryHub; docs/OBSERVABILITY.md) ---
    # path → attach a JSONL event sink (one structured record per pass)
    telemetry_jsonl: str = ""
    # ≥0 → serve Prometheus text exposition over HTTP (0 = ephemeral
    # port); -1 disables the endpoint
    telemetry_prom_port: int = -1
    # JSONL sink rotation (always-on daemon: bound the event log).
    # >0 → when the live segment exceeds this many MiB it rotates to
    # <path>.1 (older segments shift to .2, .3, ...); 0 = one unbounded
    # file (the seed behavior). telemetry_report reads rotated sets in
    # order automatically.
    telemetry_jsonl_max_mb: float = 0.0
    # rotated segments kept per JSONL path (the live file rides on top)
    telemetry_jsonl_keep: int = 3
    # quarantine a telemetry sink after this many CONSECUTIVE
    # emit/span failures (pbox_sink_errors_total books every failure;
    # a broken sink must never take the training hot path down)
    telemetry_sink_errors_max: int = 8

    # --- anomaly flight recorder (obs/flightrec;
    # docs/OBSERVABILITY.md §Flight recorder) ---
    # non-empty → keep a bounded in-memory ring of recent events/spans
    # and publish a self-contained postmortem bundle (ring + instrument
    # snapshot + critical-path blocks + FLAGS + live thread stacks)
    # into this directory whenever a trigger fires (NaN rollback,
    # reload degrade, pipeline hang, watchdog escalation, SLO breach,
    # hub.dump_blackbox). "" = recorder off (zero per-event cost).
    flightrec_dir: str = ""
    # ring capacity (events + spans, newest win)
    flightrec_ring_events: int = 512
    # per-trigger debounce: repeat fires inside this window are
    # suppressed (counted in pbox_flightrec_suppressed_total) — an
    # anomaly storm yields ONE bundle per trigger per window
    flightrec_debounce_sec: float = 60.0
    # newest bundles kept on disk per recorder dir (retention cap)
    flightrec_keep: int = 16

    # --- model-quality drift monitor (obs/quality;
    # docs/OBSERVABILITY.md §Model quality) ---
    # >0 → windowed per-pass quality stats ride every train/stream
    # pass event: key coverage/churn, embedding-norm drift vs the
    # trailing baseline, predicted-vs-observed CTR calibration buckets
    # and a windowed AUC trend with a degradation verdict
    # (pbox_quality_* instruments + quality_window events). 0 = off.
    quality_window_passes: int = 0
    # windowed-AUC degradation verdict: trailing-half mean AUC below
    # leading-half mean by more than this → pbox_quality_degraded=1
    quality_auc_drop: float = 0.01
    # coarse calibration buckets the 1e6-bin AUC tables collapse into
    quality_calibration_buckets: int = 10

    # --- SLO alert engine (obs/alerts; docs/OBSERVABILITY.md §Alerts) ---
    # >0 → evaluate the default alert rules on a cadence thread this
    # often (serving staleness / p99 / stream lag / hang / NaN-rollback
    # rate / AUC degradation → pbox_alerts_active{rule,severity},
    # alert_fired/alert_cleared events, /alertz). 0 = engine not
    # started (construct AlertEngine explicitly for manual evaluation).
    alerts_eval_interval_sec: float = 0.0
    # default-rule thresholds (staleness reuses
    # serving_staleness_max_sec; hang / NaN-rollback fire on any
    # counter increase between evaluations)
    alerts_serving_p99_ms: float = 250.0
    alerts_stream_lag_files: int = 100
    # online daemon lifecycle rules (docs/ONLINE.md): shrink_overdue
    # fires when pbox_online_windows_since_shrink exceeds this; 0 =
    # auto (2 × shrink_every_windows, rule absent when aging is off).
    # backlog_growth fires on a rising pbox_stream_lag_files trend.
    alerts_shrink_overdue_windows: int = 0

    # --- runtime ---
    # utils/profiler: StageTimers report every pass; trace() without a
    # logdir writes under the temp dir
    profile: bool = False
    # seeds the shuffles, slots_shuffle's donors and the retry jitter
    seed: int = 0

    def update(self, **kwargs: Any) -> None:
        for k, v in kwargs.items():
            if not hasattr(self, k):
                raise AttributeError(f"unknown flag: {k}")
            setattr(self, k, v)

    @classmethod
    def from_env(cls) -> "Flags":
        """Defaults overridden by ``FLAGS_<name>=...`` environment
        variables, as the reference reads them at import."""
        self = cls()
        for f in dataclasses.fields(self):
            raw = os.environ.get(f"FLAGS_{f.name}")
            if raw is not None:
                ty = type(getattr(self, f.name))
                try:
                    setattr(self, f.name, _env_cast(raw, ty))
                except ValueError as e:
                    raise ValueError(f"bad value for env flag "
                                     f"FLAGS_{f.name}={raw!r}: {e}"
                                     ) from None
        return self


def _env_cast(raw: str, ty: type) -> Any:
    if ty is bool:
        return raw.lower() in ("1", "true", "yes", "on")
    if ty is int:
        return int(raw)
    if ty is float:
        return float(raw)
    return raw


FLAGS = Flags.from_env()


@contextlib.contextmanager
def flags_scope(**kwargs: Any) -> Iterator[Flags]:
    """Override flags for the duration of the block."""
    old = {k: getattr(FLAGS, k) for k in kwargs}
    FLAGS.update(**kwargs)
    try:
        yield FLAGS
    finally:
        FLAGS.update(**old)
