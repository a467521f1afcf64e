"""Dense-parameter modes beyond the per-step gradient sum — counterpart of
``paddlebox_tpu/train/dense_modes.py``.

Reference (boxps_worker.cc):

- **per-param learning rates** (lr_map): ``InitializeGPUAndLoadModel``
  carries a param-name → lr map (box_wrapper.cc:1303-1335), consumed per
  parameter by the async dense table (boxps_worker.cc:199-204). Here a
  per-parameter UPDATE multiplier (lr / base lr) applied after the
  optimizer's step, so it composes with any optimizer (scaling the grad
  would be normalized away by Adam), with ZeRO-1's flat chunks
  (``train/sharded.Zero1``) and with the host async table.
- **sync mode** ``SyncParam`` (:1191): replicas train on their own and
  every K steps the params are averaged (``KStepParamSync``; the port is
  single-controller, so the replicas are a leading axis and the average
  is their mean).
- **async mode** ``BoxPSAsynDenseTable`` (:61-370): a host-side flat
  param vector with Adam state; workers pull the latest params and push
  grads through a queue that a background thread drains, applying Adam
  on the CPU. DataNorm summary params are accumulated (ps += grad)
  instead of Adam-updated (:93-98).
"""

from __future__ import annotations

import re
import threading
import time
from typing import Any, Callable, Dict, Mapping, Optional, Sequence, Union

import numpy as np
import torch
from torch import nn

from paddlebox_tpu_torch.train.step import OptimizerFactory
from paddlebox_tpu_torch.utils.channel import Channel


# ---------------------------------------------------------------------------
# per-param dense learning rates (lr_map)
# ---------------------------------------------------------------------------

def lr_pattern_matches(pat: str, name: str) -> bool:
    """THE lr_map matching rule: ``pat`` occurs in ``name`` with a
    non-identifier character (or a string end) on both sides, so
    ``"hidden.1"`` matches ``hidden.1.weight`` but not ``hidden.10.weight``
    (the reference's lr_map keys are exact param names; a bare substring
    test over-matches)."""
    for m in re.finditer(re.escape(pat), name):
        a = name[m.start() - 1] if m.start() else ""
        b = name[m.end()] if m.end() < len(name) else ""
        if not (a.isalnum() or a == "_") and not (b.isalnum() or b == "_"):
            return True
    return False


def build_lr_scales(params: Union[nn.Module, Mapping[str, Any]],
                    lr_map: Mapping[str, float],
                    base_lr: float) -> Dict[str, float]:
    """Per-parameter update multipliers, by name (a module's
    ``named_parameters()``, or a mapping's keys): a name that matches a
    key of ``lr_map`` (``lr_pattern_matches``) gets ``lr_map[key] /
    base_lr``, the first match winning; the rest 1.0."""
    names = (dict(params.named_parameters()) if isinstance(params, nn.Module)
             else params)
    out = {}
    for name in names:
        out[name] = 1.0
        for pat, lr in lr_map.items():
            if lr_pattern_matches(pat, name):
                out[name] = float(lr) / float(base_lr)
                break
    return out


def scale_update(old: torch.Tensor, new: torch.Tensor,
                 scale: Union[float, torch.Tensor]) -> torch.Tensor:
    """``old + scale * (new - old)``: the optimizer's update times
    ``scale``. A scale of 1 keeps ``new`` and a scale of 0 keeps ``old``,
    bit for bit."""
    if not torch.is_tensor(scale):
        if scale == 1.0:
            return new
        if scale == 0.0:
            return old
        return old + scale * (new - old)
    return torch.where(scale == 1.0, new, torch.where(
        scale == 0.0, old, old + scale * (new - old)))


class LrMapOptimizer:
    """An optimizer whose step scales each parameter's update by its
    multiplier (``build_lr_scales``). It passes ``zero_grad``,
    ``state_dict``, ``load_state_dict`` and ``param_groups`` through to
    the optimizer it wraps."""

    def __init__(self, opt: torch.optim.Optimizer,
                 params: Sequence[torch.Tensor],
                 scales: Sequence[float]) -> None:
        if len(params) != len(scales):
            raise ValueError(f"{len(scales)} lr scales for {len(params)} "
                             "params")
        self.opt = opt
        self._scaled = [(p, float(s)) for p, s in zip(params, scales)
                        if float(s) != 1.0]

    @property
    def param_groups(self):
        return self.opt.param_groups

    def step(self, closure=None):
        with torch.no_grad():
            old = [p.detach().clone() for p, _ in self._scaled]
        loss = self.opt.step(closure)
        with torch.no_grad():
            for (p, s), o in zip(self._scaled, old):
                p.copy_(scale_update(o, p, s))
        return loss

    def zero_grad(self, set_to_none: bool = True) -> None:
        self.opt.zero_grad(set_to_none=set_to_none)

    def state_dict(self) -> Dict[str, Any]:
        return self.opt.state_dict()

    def load_state_dict(self, sd: Dict[str, Any]) -> None:
        self.opt.load_state_dict(sd)


def lr_map_transform(tx: OptimizerFactory,
                     scales: Sequence[float]) -> OptimizerFactory:
    """``tx`` with each parameter's update scaled by its multiplier;
    ``scales`` follow the order of the params the factory is given (a
    module's ``parameters()``)."""
    def factory(params):
        params = list(params)
        return LrMapOptimizer(tx(params), params, scales)
    return factory


# ---------------------------------------------------------------------------
# K-step periodic parameter averaging (SyncParam)
# ---------------------------------------------------------------------------

def _tree_map(fn, tree):
    if torch.is_tensor(tree):
        return fn(tree)
    if isinstance(tree, Mapping):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    raise TypeError(f"not a tensor tree: {type(tree)}")


class KStepParamSync:
    """Average param replicas every ``k`` steps. The replicas are the
    leading axis of every tensor of a tree (dicts, lists, tuples of
    tensors): the single-controller form of one param copy per worker,
    whose allreduce-and-scale (SyncParam) is the mean over that axis."""

    def __init__(self, k: int) -> None:
        if k <= 0:
            raise ValueError("k must be positive")
        self.k = k
        self._step = 0

    def maybe_sync(self, params):
        """Call once per train step; returns (params, did_sync)."""
        self._step += 1
        if self._step % self.k != 0:
            return params, False
        return _tree_map(lambda x: x.mean(dim=0, keepdim=True).expand_as(
            x).clone(), params), True


# ---------------------------------------------------------------------------
# async host-side dense table (BoxPSAsynDenseTable)
# ---------------------------------------------------------------------------

class _HostAdam:
    def __init__(self, n: int, lr, beta1: float, beta2: float,
                 eps: float) -> None:
        """``lr`` is a scalar or a per-element [n] vector (lr_map,
        boxps_worker.cc:199-204)."""
        self.m = np.zeros(n, np.float32)
        self.v = np.zeros(n, np.float32)
        self.t = 0
        self.lr, self.b1, self.b2, self.eps = lr, beta1, beta2, eps

    def update(self, p: np.ndarray, g: np.ndarray) -> None:
        self.t += 1
        self.m = self.b1 * self.m + (1 - self.b1) * g
        self.v = self.b2 * self.v + (1 - self.b2) * g * g
        mhat = self.m / (1 - self.b1 ** self.t)
        vhat = self.v / (1 - self.b2 ** self.t)
        p -= self.lr * mhat / (np.sqrt(vhat) + self.eps)

    def _lr_sel(self, sel: np.ndarray):
        return self.lr[sel] if isinstance(self.lr, np.ndarray) else self.lr


def _host(x) -> np.ndarray:
    if torch.is_tensor(x):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float32)


class AsyncDenseTable:
    """Host-resident dense params updated by a background Adam thread.

    ``params`` is a mapping name → tensor or array (``state_dict()``
    order). ``pull()`` returns the latest params as a dict of CPU float32
    tensors (moving them to a device is the caller's); ``push(grads)``
    enqueues a grad mapping and returns at once. Params whose name
    matches ``is_summary`` (DataNorm batch_size/batch_sum/
    batch_square_sum) accumulate (ps += grad) instead of taking Adam
    steps (boxps_worker.cc:93-98)."""

    def __init__(self, params: Mapping[str, Any], lr: float = 1e-3,
                 beta1: float = 0.9, beta2: float = 0.999, eps: float = 1e-8,
                 queue_capacity: int = 64,
                 is_summary: Optional[Callable[[str], bool]] = None,
                 lr_map: Optional[Mapping[str, float]] = None) -> None:
        """``lr_map``: param-name → lr overrides (``lr_pattern_matches``,
        as in ``build_lr_scales``); the other params use ``lr``."""
        host = {k: _host(v) for k, v in params.items()}
        self._names = list(host)
        self._shapes = [host[k].shape for k in self._names]
        self._ps = np.concatenate([host[k].reshape(-1)
                                   for k in self._names]).astype(np.float32)
        pred = is_summary or (lambda name: "summary" in name.lower())
        mask = np.zeros(self._ps.size, bool)
        lr_vec = None
        scales = build_lr_scales(host, lr_map or {}, base_lr=lr)
        if lr_map:
            lr_vec = np.empty(self._ps.size, np.float32)
        off = 0
        for name in self._names:
            n = host[name].size
            if pred(name):
                mask[off:off + n] = True
            if lr_vec is not None:
                lr_vec[off:off + n] = np.float32(scales[name])
            off += n
        if lr_vec is not None:
            lr_vec = (lr * lr_vec).astype(np.float32)
        self._summary_mask = mask
        self._adam = _HostAdam(self._ps.size,
                               lr if lr_vec is None else lr_vec,
                               beta1, beta2, eps)
        self._q: Channel = Channel(capacity=queue_capacity)
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._applied = 0
        self._pushed = 0

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> None:
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="pbx-async-dense")
        self._thread.start()

    def stop(self) -> None:
        self._q.close()
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _loop(self) -> None:
        while True:
            batch = self._q.get_batch(max_items=1)
            if not batch:  # closed and drained
                return
            g = batch[0]
            with self._lock:
                s = self._summary_mask
                if s.any():
                    self._ps[s] += g[s]
                    self._adam_masked(~s, g)
                else:
                    self._adam.update(self._ps, g)
                self._applied += 1

    def _adam_masked(self, sel: np.ndarray, g: np.ndarray) -> None:
        a = self._adam
        a.t += 1
        a.m[sel] = a.b1 * a.m[sel] + (1 - a.b1) * g[sel]
        a.v[sel] = a.b2 * a.v[sel] + (1 - a.b2) * g[sel] ** 2
        mhat = a.m[sel] / (1 - a.b1 ** a.t)
        vhat = a.v[sel] / (1 - a.b2 ** a.t)
        self._ps[sel] -= a._lr_sel(sel) * mhat / (np.sqrt(vhat) + a.eps)

    # -- worker API ---------------------------------------------------------
    def pull(self) -> Dict[str, torch.Tensor]:
        with self._lock:
            snap = self._ps.copy()
        out, off = {}, 0
        for name, shape in zip(self._names, self._shapes):
            n = int(np.prod(shape, dtype=np.int64))
            out[name] = torch.from_numpy(snap[off:off + n].reshape(shape))
            off += n
        return out

    def push(self, grads: Mapping[str, Any]) -> None:
        flat = np.concatenate([_host(grads[k]).reshape(-1)
                               for k in self._names]).astype(np.float32)
        with self._lock:
            self._pushed += 1
        self._q.put(flat)

    def drain(self) -> int:
        """Block until every pushed grad is applied (a pass barrier);
        returns the updates applied in all. Counts applied against
        pushed: an empty queue alone races with the grad the worker has
        taken and not yet applied."""
        while True:
            with self._lock:
                if self._applied >= self._pushed:
                    return self._applied
            time.sleep(0.001)
