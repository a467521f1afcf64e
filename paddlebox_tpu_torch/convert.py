"""Carry state across from the JAX package, as numpy.

- ``deepfm_state_dict_from_flax``: the flax DeepFM param tree (as
  ``jax.device_get(params)`` returns it) → the port's DeepFM
  ``state_dict``. A flax Dense kernel is ``[in, out]``; a torch weight is
  ``[out, in]``.
- ``ads_rank_state_dict_from_flax``: the same for AdsRank, whose layers
  carry the flax names; ``ctr_dnn_``, ``wide_deep_``, ``dcn_v2_`` and
  ``mmoe_state_dict_from_flax`` for the other CTR models (the last takes
  an ``MMoE`` tree or an ``MMoESingle`` one, whose params sit under
  ``mmoe``).
- ``table_rows_from_logical``: keys and their logical table rows → the
  field mapping a save file holds, for a table handed over in memory
  rather than through ``.npz`` (``EmbeddingTable.load`` takes either).
- ``sharded_table_from_packed``: a JAX
  ``ShardedEmbeddingTable``'s stacked 128-lane state ``[N, L, 128]`` (as
  ``jax.device_get(table.state.packed)`` returns it) and each shard's
  ``(keys, rows)`` → the sharded save mapping (``n``, ``keys_{s}``,
  ``{field}_{s}``) the port's ``ShardedEmbeddingTable.load`` takes, each
  shard's keys in row order, so a fresh port table assigns the same
  rows where the reference's are dense.
- ``multi_mf_blobs_from_logical`` / ``multi_mf_blobs_from_packed``: a
  JAX multi-mf table's class tables (single: each class's keys, rows and
  logical rows; sharded: each class's packed state and shard items) →
  one save mapping a dim class; ``load_multi_mf`` fills a port
  ``MultiMfEmbeddingTable`` or ``MultiMfShardedTable`` from them (a
  sharded table splits a single-table mapping by ``key % N``).
- ``adam_state_from_optax``: an optax Adam state (count, mu, nu) → the
  ``state_dict`` of the port's ``torch.optim.Adam`` over the same params.
- ``dense_from_jax_checkpoint``: the unpickled ``dense.pkl`` of a
  reference checkpoint, ``(params, opt_state, auc)`` → the contents of
  the port's ``dense.pt`` (``Trainer.dense_snapshot``), so a reference
  checkpoint restores into the port. Unpickling the reference file needs
  optax, so only a caller that has it (the tests) can produce the input.
- ``block``, ``column_block``, ``row_block``, ``stage_block``,
  ``expert_block``, ``sequence_block``, ``graph_shard``: a global numpy
  array of the JAX side → THIS rank's block of it, the way the
  reference's ``shard_map`` ``in_specs`` place it (``P(None, "mp")``
  columns, ``P("mp")`` rows or vocab ranges, ``P("pp")`` stages,
  ``P("ep")`` experts, contiguous sequence blocks of ``[B, T, H, D]``,
  row s of a ``ShardedGraphStore``'s padded arrays), so every rank of a
  ``parallel.collectives.Axis`` computes what its device of the JAX mesh
  does.
"""

from __future__ import annotations

from typing import (Any, Callable, Dict, List, Mapping, Optional, Sequence,
                    Tuple)

import numpy as np
import torch

from paddlebox_tpu_torch.ps.table import FIELD_COL, NUM_FIXED


def deepfm_state_dict_from_flax(params_np: Mapping
                                ) -> Dict[str, torch.Tensor]:
    """``Dense_0`` is the dense first-order term, ``Dense_1..n`` the
    hidden layers and the last ``Dense`` the output."""
    tree = params_np.get("params", params_np)
    names = sorted((k for k in tree if k.startswith("Dense_")),
                   key=lambda k: int(k.split("_")[1]))
    if len(names) < 2:
        raise ValueError(f"not a DeepFM param tree: {sorted(tree)}")
    targets = (["first"] + [f"hidden.{i}" for i in range(len(names) - 2)]
               + ["out"])
    out: Dict[str, torch.Tensor] = {}
    for name, tgt in zip(names, targets):
        out.update(_dense_params(tree[name], tgt))
    return out


def _dense_params(layer: Mapping, name: str) -> Dict[str, torch.Tensor]:
    kernel = np.asarray(layer["kernel"], np.float32)
    bias = np.asarray(layer["bias"], np.float32)
    return {f"{name}.weight": torch.from_numpy(kernel.T.copy()),
            f"{name}.bias": torch.from_numpy(bias.copy())}


def ads_rank_state_dict_from_flax(params_np: Mapping
                                  ) -> Dict[str, torch.Tensor]:
    """The flax AdsRank tree → the port's AdsRank ``state_dict``: the
    ``slot_fc_w`` / ``slot_fc_b`` / ``rank_param`` arrays as they are,
    the ``ad_proj``, ``mlp_{i}`` and ``head`` Dense layers transposed."""
    tree = params_np.get("params", params_np)
    if "rank_param" not in tree or "ad_proj" not in tree:
        raise ValueError(f"not an AdsRank param tree: {sorted(tree)}")
    out: Dict[str, torch.Tensor] = {}
    for name in ("slot_fc_w", "slot_fc_b", "rank_param"):
        if name in tree:
            out[name] = torch.from_numpy(
                np.array(tree[name], dtype=np.float32))
    mlps = sorted((k for k in tree if k.startswith("mlp_")),
                  key=lambda k: int(k.split("_")[1]))
    for name in ["ad_proj", *mlps, "head"]:
        out.update(_dense_params(tree[name], name))
    return out


def _dense_names(tree: Mapping) -> list:
    """The tree's auto-named ``Dense_i`` layers in index order."""
    return sorted((k for k in tree if k.startswith("Dense_")),
                  key=lambda k: int(k.split("_")[1]))


def _tower(tree: Mapping, names: Sequence[str], tail: str
           ) -> Dict[str, torch.Tensor]:
    """``names`` as ``hidden.{i}``, then ``tail`` for the last one."""
    out: Dict[str, torch.Tensor] = {}
    for i, name in enumerate(names[:-1]):
        out.update(_dense_params(tree[name], f"hidden.{i}"))
    out.update(_dense_params(tree[names[-1]], tail))
    return out


def ctr_dnn_state_dict_from_flax(params_np: Mapping
                                 ) -> Dict[str, torch.Tensor]:
    """CtrDnn: ``Dense_0..n-1`` the hidden layers, the last the output."""
    tree = params_np.get("params", params_np)
    names = _dense_names(tree)
    if not names:
        raise ValueError(f"not a CtrDnn param tree: {sorted(tree)}")
    return _tower(tree, names, "out")


def wide_deep_state_dict_from_flax(params_np: Mapping
                                   ) -> Dict[str, torch.Tensor]:
    """WideDeep: ``wide_linear``, the ``Dense_i`` hidden layers and
    ``deep_out``."""
    tree = params_np.get("params", params_np)
    if "wide_linear" not in tree or "deep_out" not in tree:
        raise ValueError(f"not a WideDeep param tree: {sorted(tree)}")
    out = _dense_params(tree["wide_linear"], "wide_linear")
    names = _dense_names(tree) + ["deep_out"]
    out.update(_tower(tree, names, "deep_out"))
    return out


def dcn_v2_state_dict_from_flax(params_np: Mapping
                                ) -> Dict[str, torch.Tensor]:
    """DCNv2: ``CrossLayer_l/Dense_0`` → ``cross.{l}.dense``, the
    ``Dense_i`` hidden layers, the last Dense the output."""
    tree = params_np.get("params", params_np)
    cross = sorted((k for k in tree if k.startswith("CrossLayer_")),
                   key=lambda k: int(k.split("_")[1]))
    names = _dense_names(tree)
    if not names:
        raise ValueError(f"not a DCNv2 param tree: {sorted(tree)}")
    out: Dict[str, torch.Tensor] = {}
    for i, name in enumerate(cross):
        out.update(_dense_params(tree[name]["Dense_0"], f"cross.{i}.dense"))
    out.update(_tower(tree, names, "out"))
    return out


def mmoe_state_dict_from_flax(params_np: Mapping
                              ) -> Dict[str, torch.Tensor]:
    """MMoE (or MMoESingle, its params under ``mmoe``, the port's names
    then prefixed ``mmoe.``): the expert arrays as they are, ``gate{t}``
    → ``gates.{t}``, ``tower{t}_{i}`` → ``towers.{t}.{i}``, ``head{t}`` →
    ``heads.{t}``."""
    tree = params_np.get("params", params_np)
    prefix = ""
    if "mmoe" in tree:
        tree, prefix = tree["mmoe"], "mmoe."
    if "expert_w0" not in tree:
        raise ValueError(f"not an MMoE param tree: {sorted(tree)}")
    out: Dict[str, torch.Tensor] = {}
    for name, v in tree.items():
        if name.startswith("expert_"):
            out[prefix + name] = torch.from_numpy(
                np.array(v, dtype=np.float32))
        elif name.startswith("gate"):
            out.update(_dense_params(v, f"{prefix}gates.{name[4:]}"))
        elif name.startswith("tower"):
            t, i = name[5:].split("_")
            out.update(_dense_params(v, f"{prefix}towers.{t}.{i}"))
        elif name.startswith("head"):
            out.update(_dense_params(v, f"{prefix}heads.{name[4:]}"))
    return out


def table_rows_from_logical(keys: np.ndarray, logical_np: np.ndarray,
                            mf_dim: int) -> Dict[str, np.ndarray]:
    """keys [n] uint64 and their logical rows [n, 8+mf_dim+ext] → the
    ``save_base`` field mapping (``keys``, one array per field, and
    ``opt_ext`` when the rows carry an optimizer extension)."""
    rows = np.asarray(logical_np, np.float32)
    mf_end = NUM_FIXED + mf_dim
    blob = {"keys": np.ascontiguousarray(keys, np.uint64)}
    for f, c in FIELD_COL.items():
        blob[f] = rows[:, c].copy()
    blob["embedx_w"] = rows[:, NUM_FIXED:mf_end].copy()
    if rows.shape[1] > mf_end:
        blob["opt_ext"] = rows[:, mf_end:].copy()
    return blob


def _unpack_rows(packed: np.ndarray, capacity: int, feat: int
                 ) -> np.ndarray:
    """The reference's packed table ``[..., L, 128]`` (``128 // f_pad``
    logical rows a line, f_pad = ``feat`` rounded up to a power of two)
    → its logical rows ``[..., C+1, feat]`` (a view)."""
    fp = next(d for d in (1, 2, 4, 8, 16, 32, 64, 128) if d >= feat)
    rpl = 128 // fp
    n_lines = (capacity + 1 + rpl - 1) // rpl
    lead = packed.shape[:-2]
    return packed.reshape(*lead, n_lines * rpl, fp)[..., :capacity + 1,
                                                    :feat]


def sharded_table_from_packed(packed: np.ndarray,
                              shard_items: Sequence[Tuple[np.ndarray,
                                                          np.ndarray]],
                              capacity: int, mf_dim: int, ext: int = 0
                              ) -> Dict[str, np.ndarray]:
    """A reference sharded table (its stacked packed state and each
    shard's ``index.items()``) → the sharded save mapping."""
    logical = _unpack_rows(np.asarray(packed), capacity,
                           NUM_FIXED + mf_dim + ext)
    blob: Dict[str, np.ndarray] = {"n": np.asarray(len(shard_items))}
    for s, (keys, rows) in enumerate(shard_items):
        order = np.argsort(rows, kind="stable")
        part = table_rows_from_logical(keys[order],
                                       logical[s][rows[order]], mf_dim)
        blob[f"keys_{s}"] = part.pop("keys")
        for f, v in part.items():
            blob[f"{f}_{s}"] = v
    return blob


def multi_mf_blobs_from_logical(
        classes: Sequence[Tuple[np.ndarray, np.ndarray, np.ndarray, int]],
        slots: Optional[Sequence[np.ndarray]] = None
        ) -> List[Dict[str, np.ndarray]]:
    """Per dim class ``(keys, rows, logical [C+1, F], mf_dim)`` (a JAX
    ``EmbeddingTable``'s ``index.items()`` and its logical state) → one
    save mapping a class, keys in row order (a fresh port table then
    assigns the same rows where the reference's are dense). ``slots``
    (per class, the slot of each row, e.g. the JAX table's
    ``slot_host``) fills the slot field, which the single table keeps
    on the host rather than in its rows."""
    out = []
    for c, (keys, rows, logical, mf_dim) in enumerate(classes):
        order = np.argsort(rows, kind="stable")
        rows = np.asarray(rows)[order]
        blob = table_rows_from_logical(np.asarray(keys)[order],
                                       np.asarray(logical)[rows], mf_dim)
        if slots is not None:
            blob["slot"] = np.asarray(slots[c])[rows].astype(np.float32)
        out.append(blob)
    return out


def multi_mf_blobs_from_packed(
        classes: Sequence[Tuple[np.ndarray, Sequence, int, int]]
        ) -> List[Dict[str, np.ndarray]]:
    """Per dim class ``(packed [N, L, 128], shard items, capacity,
    mf_dim)`` of a JAX ``MultiMfShardedTable`` → one sharded save
    mapping a class (``sharded_table_from_packed``)."""
    return [sharded_table_from_packed(packed, items, cap, mf_dim)
            for packed, items, cap, mf_dim in classes]


def load_multi_mf(table, blobs: Sequence[Mapping[str, np.ndarray]]) -> int:
    """Load one mapping a dim class into a port multi-mf table's class
    tables (in class order). Returns the rows loaded."""
    if len(blobs) != len(table.tables):
        raise ValueError(f"{len(blobs)} mappings for "
                         f"{len(table.tables)} dim classes")
    return sum(t.load(b) for t, b in zip(table.tables, blobs))


def _adam_leaf(opt_state: Any):
    """The (count, mu, nu) node of an optax state: ``optax.adam`` is a
    chain whose first element is ``ScaleByAdamState``."""
    if all(hasattr(opt_state, f) for f in ("count", "mu", "nu")):
        return opt_state
    if isinstance(opt_state, (tuple, list)):
        for part in opt_state:
            found = _adam_leaf(part)
            if found is not None:
                return found
    return None


def adam_state_from_optax(opt_state: Any, optimizer: torch.optim.Optimizer,
                          param_names: Sequence[str],
                          convert_tree: Callable[[Mapping], Dict[str,
                                                                 torch.Tensor]]
                          = deepfm_state_dict_from_flax
                          ) -> Dict[str, Any]:
    """An optax Adam state (as ``jax.device_get`` returns it) → the
    ``state_dict`` of ``optimizer``, a ``torch.optim.Adam`` over the
    params named ``param_names`` in its order (``[n for n, _ in
    model.named_parameters()]``). ``convert_tree`` maps a flax param tree
    to ``state_dict`` names, as for the params themselves: the moments
    have the params' shapes. Both optimizers keep the same moments and
    step count, so the next update is the same up to rounding."""
    adam = _adam_leaf(opt_state)
    if adam is None:
        raise ValueError("no Adam (count, mu, nu) node in the optax state")
    mu, nu = convert_tree(adam.mu), convert_tree(adam.nu)
    step = float(np.asarray(adam.count))
    sd = optimizer.state_dict()
    sd["state"] = {
        i: {"step": torch.tensor(step),
            "exp_avg": mu[name].clone(), "exp_avg_sq": nu[name].clone()}
        for i, name in enumerate(param_names)}
    return sd


def dense_from_jax_checkpoint(blob: Sequence, model: torch.nn.Module,
                              optimizer: torch.optim.Optimizer,
                              convert_tree: Callable[[Mapping],
                                                     Dict[str, torch.Tensor]]
                              = deepfm_state_dict_from_flax
                              ) -> Dict[str, Any]:
    """A reference checkpoint's unpickled ``dense.pkl``, ``(params,
    opt_state, auc)`` with ``auc`` the reference's ``AucState`` (pos,
    neg, abs_err, sqr_err, pred_sum, label_sum, ins_num) → the port's
    ``dense.pt`` contents for ``model`` and ``optimizer`` (the trainer's
    own, which give the param order and the Adam hyperparameters)."""
    params, opt_state, auc = blob
    names = [n for n, _ in model.named_parameters()]
    pos, neg, *sums = (np.asarray(x, np.float32) for x in auc)
    return {
        "model": convert_tree(params),
        "opt": adam_state_from_optax(opt_state, optimizer, names,
                                     convert_tree),
        "auc": {"buckets": torch.from_numpy(np.stack([pos, neg])),
                "sums": torch.from_numpy(np.array(
                    [float(x) for x in sums], np.float32))}}


def block(arr, rank: int, size: int, dim: int = 0) -> torch.Tensor:
    """Block ``rank`` of ``size`` contiguous blocks of ``arr`` (a numpy
    array, or a tensor, whose block stays on its device) along ``dim``
    (a ``PartitionSpec`` naming the axis at ``dim``)."""
    t = arr if isinstance(arr, torch.Tensor) else \
        torch.from_numpy(np.asarray(arr))
    dim %= t.dim()
    n = t.shape[dim]
    if n % size:
        raise ValueError(f"dimension {dim} of size {n} does not split over "
                         f"{size} ranks")
    per = n // size
    out = t.narrow(dim, rank * per, per).contiguous()
    # a numpy input's block owns its memory (not a view of the array)
    return out if isinstance(arr, torch.Tensor) else out.clone()


def column_block(w, rank: int, size: int) -> torch.Tensor:
    """``P(None, "mp")``: a column-parallel weight's output columns (a
    1-D bias's entries)."""
    return block(w, rank, size, dim=-1)


def row_block(w, rank: int, size: int) -> torch.Tensor:
    """``P("mp")``: a row-parallel weight's input rows, or a vocab
    range of an embedding."""
    return block(w, rank, size, dim=0)


def stage_block(ws, rank: int, size: int) -> torch.Tensor:
    """``P("pp")`` over stacked stage weights ``[S, ...]`` with one stage
    a rank: this rank's stage, its leading axis dropped (what the
    reference's ``ws_sharded[0]`` reads)."""
    return block(ws, rank, size, dim=0)[0]


def expert_block(params, rank: int, size: int) -> torch.Tensor:
    """``P("ep")``: this rank's experts ``[E / size, ...]``."""
    return block(params, rank, size, dim=0)


def sequence_block(x, rank: int, size: int) -> torch.Tensor:
    """``P(None, axis, None, None)`` over ``[B, T, H, D]``: positions
    ``[rank * T/size, (rank + 1) * T/size)``."""
    return block(x, rank, size, dim=1)


def graph_shard(store, s: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Row ``s`` of a ``ShardedGraphStore``'s (either package's) padded
    ``indptr`` / ``indices``: shard s's local CSR."""
    return (torch.from_numpy(np.ascontiguousarray(store.indptr[s])),
            torch.from_numpy(np.ascontiguousarray(store.indices[s])))
