"""Always-on online-learning daemon launcher (the port's counterpart of
``scripts/onlinelearn.py``).

One process composing train -> publish -> serve over a watched
directory: ``--data-dir`` is polled for ``*.txt`` arrivals (criteo
lines); completed windows publish boundary checkpoints into
``<workdir>/registry`` (the artifact feed); ``--serve`` also runs a
hot-reloading serving snapshot off the same registry. Feature lifecycle
(``--shrink-every``) ages the model on the daemon's window clock.

Preemption contract: SIGTERM/SIGINT triggers a graceful stop (an
emergency boundary checkpoint and ``RESUME.json``) and the process exits
``EXIT_RESUME`` (75). Relaunching with the same ``--workdir`` consumes the
marker and resumes the open window at-least-once; after a SIGKILL it
resumes from the newest checkpoint the same way, without the marker. A
launcher loop is one line::

    until python -m paddlebox_tpu_torch.tools.onlinelearn --workdir W \\
            --data-dir D; do
        [ $? -eq 75 ] || break
    done

Health: ``--healthz-port`` serves /healthz (with the daemon's ``online``
block), /readyz, /metrics and /alertz, and prints
``{"healthz_port": N}`` on a line of its own. Exit code 0 = the bounded
run (``--max-windows`` / ``--max-idle-polls``) drained cleanly; 75 =
resume requested; anything else is a real failure.

The trainer and the server run on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description=__doc__.splitlines()[0],
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    ap.add_argument("--workdir", required=True,
                    help="daemon state root: ckpt/, registry/, "
                         "telemetry.jsonl live here")
    ap.add_argument("--data-dir", required=True,
                    help="watched directory; *.txt files are the "
                         "arriving stream")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--batch-size", type=int, default=16)
    ap.add_argument("--window-files", type=int, default=2,
                    help="files per stream window")
    ap.add_argument("--ckpt-every", type=int, default=1,
                    help="boundary checkpoint every N windows")
    ap.add_argument("--shrink-every", type=int, default=0,
                    help="shrink cycle every N windows (0 = off)")
    ap.add_argument("--shrink-threshold", type=float, default=0.0)
    ap.add_argument("--decay", type=float, default=0.98,
                    help="show/click decay per shrink cycle")
    ap.add_argument("--max-windows", type=int, default=None,
                    help="stop after N windows (None = run forever)")
    ap.add_argument("--max-idle-polls", type=int, default=None,
                    help="stop after N consecutive empty polls "
                         "(None = poll forever)")
    ap.add_argument("--serve", action="store_true",
                    help="run the hot-reloading serving leg too")
    ap.add_argument("--healthz-port", type=int, default=-1,
                    help=">=0: serve /healthz /metrics on this port "
                         "(0 = ephemeral)")
    ap.add_argument("--alerts-interval", type=float, default=0.0,
                    help=">0: evaluate default alert rules this often")
    ap.add_argument("--capacity", type=int, default=1 << 12,
                    help="embedding table capacity (rows)")
    ap.add_argument("--mf-dim", type=int, default=4)
    ap.add_argument("--ckpt-keep", type=int, default=3,
                    help="boundary checkpoints retained on disk")
    ap.add_argument("--device", default="cuda",
                    help="where the trainer and the server run "
                         "(cuda or cpu)")
    return ap


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    import torch

    from paddlebox_tpu_torch.config import flags_scope
    from paddlebox_tpu_torch.data import DataFeedDesc, DatasetFactory
    from paddlebox_tpu_torch.models import CtrDnn
    from paddlebox_tpu_torch.obs.hub import get_hub
    from paddlebox_tpu_torch.online import OnlineLearner
    from paddlebox_tpu_torch.ps.sgd import SparseSGDConfig
    from paddlebox_tpu_torch.ps.table import EmbeddingTable
    from paddlebox_tpu_torch.resilience import preemption
    from paddlebox_tpu_torch.resilience.preemption import (EXIT_RESUME,
                                                           PreemptedError)
    from paddlebox_tpu_torch.serving import ServingModel
    from paddlebox_tpu_torch.train.checkpoint import CheckpointManager
    from paddlebox_tpu_torch.train.trainer import Trainer

    workdir = os.path.abspath(args.workdir)
    data_dir = os.path.abspath(args.data_dir)
    os.makedirs(workdir, exist_ok=True)
    ckpt_root = os.path.join(workdir, "ckpt")
    dev = args.device
    with flags_scope(
            seed=args.seed,
            telemetry_jsonl=os.path.join(workdir, "telemetry.jsonl"),
            stream_window_files=args.window_files,
            stream_ckpt_every_windows=args.ckpt_every,
            shrink_every_windows=args.shrink_every,
            shrink_delete_threshold=args.shrink_threshold,
            show_click_decay_rate=args.decay,
            alerts_eval_interval_sec=args.alerts_interval,
            graceful_shutdown=True,
            read_thread_num=1):
        desc = DataFeedDesc.criteo(batch_size=args.batch_size)
        desc.key_bucket_min = 2048
        cfg = SparseSGDConfig(mf_create_thresholds=0.0,
                              mf_initial_range=0.0)
        table = EmbeddingTable(mf_dim=args.mf_dim,
                               capacity=args.capacity, cfg=cfg,
                               unique_bucket_min=2048, device=dev)
        width = 3 + args.mf_dim
        torch.manual_seed(args.seed)
        trainer = Trainer(CtrDnn(26, width, 13, hidden=(8,)), table, desc,
                          tx=lambda p: torch.optim.Adam(p, lr=1e-2),
                          seed=args.seed, device=dev)
        cm = CheckpointManager(ckpt_root, keep=args.ckpt_keep,
                               artifacts=os.path.join(workdir, "registry"))
        resumed = None
        if cm.latest_step() is not None:
            resumed = cm.restore(trainer)

        def filelist_fn():
            return sorted(glob.glob(os.path.join(data_dir, "*.txt")))

        def mkds():
            ds = DatasetFactory().create_dataset("QueueDataset", desc)
            ds.set_filelist(filelist_fn())
            return ds

        serving = None
        if args.serve:
            serving = ServingModel(CtrDnn(26, width, 13, hidden=(8,)), desc,
                                   mf_dim=args.mf_dim,
                                   capacity=args.capacity, device=dev)
        hub = get_hub()
        server = None
        if args.healthz_port >= 0:
            server = hub.start_prom_http(args.healthz_port)
            # the port line is a contract: test harnesses parse it
            print(json.dumps({"healthz_port":
                              server.server_address[1]}), flush=True)
        learner = OnlineLearner(
            trainer, mkds, cm, serving=serving,
            store=cm.artifacts if args.serve else None,
            filelist_fn=filelist_fn, max_windows=args.max_windows,
            max_idle_polls=args.max_idle_polls)
        status = {"resumed_step": resumed}
        try:
            totals = learner.run()
        except PreemptedError as e:
            status.update(learner.online_status(),
                          preempted=True, step=e.step,
                          checkpointed=e.checkpointed)
            print(json.dumps(status), flush=True)
            return EXIT_RESUME
        finally:
            if server is not None:
                hub.stop_prom_http()
        status.update(learner.online_status(), preempted=False,
                      totals={k: v for k, v in totals.items()
                              if isinstance(v, (int, float))})
        print(json.dumps(status), flush=True)
        # a clean bounded exit must not leave a stale resume marker
        preemption.clear_resume_marker(ckpt_root)
        return 0


if __name__ == "__main__":
    sys.exit(main())
