"""Run phase 21 and then phase 20 of ``chip_smoke.py`` on the card for
several rounds, and record what each phase leaves behind.

    python3 chip_phases.py [apart|together,...]

One round a word (default ``apart,together,apart,together,apart,
together``): ``together`` draws the coordinator ports of phase 20's two
gangs at once, as ``chip_smoke.py`` does; ``apart`` draws them one after
the other, so the two could get the same port. Before phase 21 and after
each phase it snapshots the processes this one started (or any
``chip_smoke`` rank), the listening TCP ports, this process's socket
descriptors and threads, the allocator's card memory and the card's
compute processes. Prints one ``ROUND`` line a round and writes every
round's phase results and snapshots to ``chiprun_out/phases/rounds.json``.
Exits 1 if a phase failed in any round.
"""

import json
import os
import subprocess
import sys
import threading
import time
import traceback
from argparse import Namespace

os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

ME = os.getpid()


def snapshot() -> dict:
    procs = []
    for pid in os.listdir("/proc"):
        if not pid.isdigit() or int(pid) == ME:
            continue
        try:
            stat = open(f"/proc/{pid}/stat").read()
            ppid = int(stat.rsplit(")", 1)[1].split()[1])
            cmd = open(f"/proc/{pid}/cmdline", "rb").read().replace(
                b"\0", b" ").decode(errors="replace")[:160]
        except OSError:
            continue
        if ppid == ME or "chip_smoke" in cmd:
            procs.append([int(pid), ppid, cmd])
    listen = []
    for f in ("/proc/net/tcp", "/proc/net/tcp6"):
        for line in open(f).readlines()[1:]:
            p = line.split()
            if p[3] == "0A":
                listen.append(int(p[1].split(":")[1], 16))
    socks = 0
    for fd in os.listdir("/proc/self/fd"):
        try:
            socks += os.readlink(f"/proc/self/fd/{fd}").startswith("socket:")
        except OSError:
            pass
    smi = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid,used_memory",
         "--format=csv,noheader"], capture_output=True, text=True)
    return {"procs": procs, "listen": sorted(listen), "my_sockets": socks,
            "threads": [t.name for t in threading.enumerate()],
            "reserved": torch.cuda.memory_reserved(),
            "gpu_apps": smi.stdout.strip().splitlines()}


def main() -> int:
    modes = (sys.argv[1] if len(sys.argv) > 1 else
             "apart,together,apart,together,apart,together").split(",")
    if not torch.cuda.is_available():
        print("chip_phases: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from paddlebox_tpu_torch import native
    from paddlebox_tpu_torch.ops import _build
    card = cs.card_line()
    print("card:", card, flush=True)
    native.load()
    _build.build()
    together = cs._free_ports
    drawn: list = []

    def draw(mode):
        def ports(n):
            got = (together(n) if mode == "together"
                   else [together(1)[0] for _ in range(n)])
            drawn.append(got)
            return got
        return ports

    rounds = []
    for i, mode in enumerate(modes):
        cs._free_ports = draw(mode)
        rec = {"round": i, "mode": mode, "before21": snapshot()}
        for phase in ("21", "20"):
            details: dict = {}
            drawn.clear()
            t0 = time.time()
            try:
                if phase == "21":
                    cs.parallel_phase(torch, Namespace(seed=0), card, details)
                else:
                    cs.pod_phase(torch, Namespace(seed=0), card,
                                 cs.ragged_desc(), details)
                rec[f"p{phase}"] = "ok"
            except Exception:
                rec[f"p{phase}"] = traceback.format_exc()[-800:]
            rec[f"p{phase}_s"] = time.time() - t0
            rec[f"ports{phase}"] = list(drawn)
            rec[f"after{phase}"] = snapshot()
            rec[f"details{phase}"] = details
        rounds.append(rec)
        a = rec["after21"]
        print(f"ROUND {i} {mode}: p21 {rec['p21'][:200]!r} "
              f"{rec['p21_s']:.1f}s p20 {rec['p20'][:200]!r} "
              f"{rec['p20_s']:.1f}s ports {rec['ports20']} after 21: procs "
              f"{len(a['procs'])} listen {a['listen']} threads "
              f"{a['threads']} reserved {a['reserved']}", flush=True)
    os.makedirs("chiprun_out/phases", exist_ok=True)
    with open("chiprun_out/phases/rounds.json", "w") as fh:
        json.dump(rounds, fh, default=str, indent=1)
    failed = [r["round"] for r in rounds
              if r["p21"] != "ok" or r["p20"] != "ok"]
    print("failed rounds:", failed)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
