"""One rank of the CPU gangs of ``tests/test_torch_parallel_layers.py``,
``test_torch_moe.py``, ``test_torch_ring_attention.py`` and
``test_torch_graph.py``: started by ``distributed.launch.launch_local``
with ``PBOX_TORCH_DISTRIBUTED=1`` over gloo, it forms the process group
with ``init_runtime_env``, runs every case of one suite on its own block
of the inputs (cut by the ``convert`` helpers) and writes
``<out>/rank<r>.npz``. The port only: no JAX here.

    python tests/torch_parallel_worker.py <suite> <in.pt> <out_dir>
"""

import os
import sys

import numpy as np
import torch

WORKER = os.path.abspath(__file__)
REPO = os.path.dirname(os.path.dirname(WORKER))
if REPO not in sys.path:        # run as a script: the repo is not on the path
    sys.path.insert(0, REPO)

from paddlebox_tpu_torch.distributed.launch import (  # noqa: E402
    init_runtime_env)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def suite_layers(cfg, rank):
    from paddlebox_tpu_torch import convert as C
    from paddlebox_tpu_torch.parallel import (column_parallel_linear,
                                              make_mesh, pipeline_run,
                                              pipeline_train_step,
                                              row_parallel_linear,
                                              vocab_parallel_embedding)
    from paddlebox_tpu_torch.parallel.collectives import psum
    from paddlebox_tpu_torch.parallel.mesh import (hierarchical_allreduce,
                                                   make_hierarchical_mesh)
    mp = make_mesh(axis_name="mp", device="cpu")
    pp = make_mesh(axis_name="pp", device="cpu")
    n = mp.size
    out = {}
    c = cfg["emb"]
    out["emb"] = vocab_parallel_embedding(
        _t(c["ids"]), C.row_block(c["w"], rank, n), mp)

    c = cfg["mlp"]
    h = column_parallel_linear(_t(c["x"]), C.column_block(c["w1"], rank, n),
                               C.column_block(c["b1"], rank, n),
                               gather_output=False, axis=mp)
    out["mlp"] = row_parallel_linear(torch.relu(h),
                                     C.row_block(c["w2"], rank, n),
                                     _t(c["b2"]), axis=mp)
    c = cfg["gather"]
    out["gather"] = column_parallel_linear(
        _t(c["x"]), C.column_block(c["w"], rank, n), axis=mp)

    def stage(w, a):
        return torch.tanh(a @ w)

    c = cfg["pipe"]
    out["pipe"] = psum(pipeline_run(stage, C.stage_block(c["ws"], rank, n),
                                    _t(c["x"]), pp), pp)

    c = cfg["pipe_train"]
    w = C.stage_block(c["ws"], rank, n)
    x, y = _t(c["x"]), _t(c["y"])
    losses = []
    for _ in range(c["steps"]):
        loss, g = pipeline_train_step(
            stage, lambda o, yy: torch.mean((o - yy) ** 2), w, x, y, pp)
        w = w - c["lr"] * g
        losses.append(float(loss))
    out["pipe_losses"] = torch.tensor(losses, dtype=torch.float64)
    out["pipe_w"] = w

    # the psum of a replicated loss: its backward is the identity, so the
    # local gradient of psum(sum(w^2)) is 2w, not world * 2w
    c = cfg["grad_scale"]
    w = C.row_block(c["w"], rank, n).requires_grad_(True)
    psum(torch.sum(w ** 2), mp).backward()
    out["grad_scale"] = w.grad

    c = cfg["hier"]
    dcn, ici = make_hierarchical_mesh(c["slices"], device="cpu")
    x = _t(c["x"][rank])
    out["hier"] = hierarchical_allreduce(x, ici, dcn)
    out["hier_flat"] = psum(x, mp)
    out["hier_axes"] = torch.tensor([dcn.rank, dcn.size, ici.rank,
                                     ici.size])
    return out


def suite_moe(cfg, rank):
    from paddlebox_tpu_torch import convert as C
    from paddlebox_tpu_torch.parallel import (make_mesh, moe_forward_local,
                                              moe_forward_sharded)
    ep = make_mesh(axis_name="ep", device="cpu")
    n = ep.size
    out = {}

    def scale(x, s):
        return x * s

    def ffn(x, p):
        w1, w2 = p
        return torch.relu(x @ w1) @ w2

    for name, c in cfg.items():
        fn = scale if c["expert"] == "scale" else ffn
        params = (C.expert_block(c["params"], rank, n)
                  if c["expert"] == "scale" else
                  tuple(C.expert_block(p, rank, n) for p in c["params"]))
        x = C.row_block(c["x"], rank, n)
        fwd = moe_forward_sharded(ep, fn, capacity=c["capacity"],
                                  gate=c["gate"])
        y, aux = fwd(x, _t(c["gate_w"]), params)
        out[f"{name}_y"], out[f"{name}_aux"] = y, aux
        # the port's local form on this rank's tokens, every expert here
        allp = (_t(c["params"]) if c["expert"] == "scale" else
                tuple(_t(p) for p in c["params"]))
        yl, auxl = moe_forward_local(x, _t(c["gate_w"]), fn, allp,
                                     capacity=c["capacity"], gate=c["gate"])
        out[f"{name}_local_y"], out[f"{name}_local_aux"] = yl, auxl
    return out


def suite_ring(cfg, rank):
    from paddlebox_tpu_torch import convert as C
    from paddlebox_tpu_torch.parallel import (make_context_parallel_attention,
                                              make_mesh)
    sp = make_mesh(axis_name="sp", device="cpu")
    n = sp.size
    out = {}
    for name, c in cfg.items():
        attn = make_context_parallel_attention(sp, kind=c["kind"],
                                               causal=c["causal"])
        q, k, v = (C.sequence_block(c[a], rank, n).requires_grad_(c["grad"])
                   for a in "qkv")
        o = attn(q, k, v)
        out[f"{name}_out"] = o
        if c["grad"]:
            # every rank seeds its own part of sum(out^2): the collectives'
            # backwards assemble the gradient of the global sum
            (o ** 2).sum().backward()
            for a, t in zip("qkv", (q, k, v)):
                out[f"{name}_d{a}"] = t.grad
    return out


def suite_graph(cfg, rank):
    from paddlebox_tpu_torch import convert as C
    from paddlebox_tpu_torch.graph import GraphStore, ShardedGraphStore
    from paddlebox_tpu_torch.parallel import make_mesh
    dp = make_mesh(device="cpu")
    g = GraphStore.from_edges(cfg["src"], cfg["dst"], n_nodes=cfg["n"])
    sg = ShardedGraphStore(g, dp.size)
    ip, ix = C.graph_shard(sg, rank)
    out = {"indptr": ip, "indices": ix}
    sampler = sg.make_sampler(dp, k=cfg["k"], q_per_shard=cfg["q"], seed=5)
    q = _t(cfg["queries"][rank])
    out["jax_draws"] = sampler(ip, ix, q, draws=_t(cfg["draws"][rank]))
    out["own_draws"] = sampler(ip, ix, q)
    try:
        sampler(ip, ix, _t(np.zeros(cfg["q"] + 1, np.int32)))
        out["overflow_raised"] = torch.tensor(0)
    except ValueError:
        out["overflow_raised"] = torch.tensor(1)
    return out


SUITES = {"layers": suite_layers, "moe": suite_moe, "ring": suite_ring,
          "graph": suite_graph}


class Gang:
    """``run_gang`` in a thread, started at once: a test file's JAX side
    runs while its ranks start; ``ranks()`` waits for them."""

    def __init__(self, suite: str, cfg: dict, work) -> None:
        import threading
        self.cfg = cfg
        self._out: dict = {}

        def run() -> None:
            try:
                self._out["ranks"] = run_gang(suite, cfg, work)
            except BaseException as e:  # re-raised by ranks()
                self._out["err"] = e

        self._thread = threading.Thread(target=run, daemon=True,
                                        name=f"gang-{suite}")
        self._thread.start()

    def ranks(self) -> list:
        self._thread.join(300.0)
        if self._thread.is_alive():
            raise TimeoutError("the gang's launcher did not return")
        if "err" in self._out:
            raise self._out["err"]
        return self._out["ranks"]


def run_gang(suite: str, cfg: dict, work, nproc: int = 4,
             timeout: float = 120.0) -> list:
    """Run ``suite`` as ``nproc`` gloo CPU ranks through the port's
    ``launch_local``; returns each rank's results (name → numpy array),
    rank order. Each rank runs on one thread (``main``)."""
    from paddlebox_tpu_torch.distributed.launch import (LaunchConfig,
                                                        launch_local)
    from torch_pod_worker import free_port
    work = str(work)
    cfg_path = os.path.join(work, f"{suite}_cfg.pt")
    out_dir = os.path.join(work, f"{suite}_out")
    os.makedirs(out_dir, exist_ok=True)
    torch.save(cfg, cfg_path)
    rc = launch_local(
        [sys.executable, WORKER, suite, cfg_path, out_dir],
        LaunchConfig(nproc=nproc, coordinator=f"127.0.0.1:{free_port()}",
                     distributed=True, backend="gloo", timeout_sec=timeout,
                     stop_grace_sec=2.0))
    assert rc == 0, f"{suite}: the ranks exited {rc}"
    res = []
    for r in range(nproc):
        with np.load(os.path.join(out_dir, f"rank{r}.npz")) as z:
            res.append({k: z[k] for k in z.files})
    return res


def main() -> int:
    suite, cfg_path, out_dir = sys.argv[1:4]
    torch.set_num_threads(1)
    cfg = torch.load(cfg_path, weights_only=False)
    info = init_runtime_env()
    rank = info["rank"]
    out = SUITES[suite](cfg, rank)
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"),
             **{k: v.detach().cpu().numpy() for k, v in out.items()})
    import torch.distributed as dist
    dist.barrier()
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
