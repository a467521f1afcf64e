"""Carry state across from the JAX package, as numpy.

- ``deepfm_state_dict_from_flax``: the flax DeepFM param tree (as
  ``jax.device_get(params)`` returns it) → the port's DeepFM
  ``state_dict``. A flax Dense kernel is ``[in, out]``; a torch weight is
  ``[out, in]``.
- ``ads_rank_state_dict_from_flax``: the same for AdsRank, whose layers
  carry the flax names.
- ``table_rows_from_logical``: keys and their logical table rows → the
  field mapping a save file holds, for a table handed over in memory
  rather than through ``.npz`` (``EmbeddingTable.load`` takes either).
"""

from __future__ import annotations

from typing import Dict, Mapping

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
