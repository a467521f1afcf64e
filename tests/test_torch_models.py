"""The port's CTR models (``CtrDnn``, ``WideDeep``, ``DCNv2``, ``MMoE``,
``MMoESingle``) against the JAX package's flax modules, on the CPU.

Params cross through ``convert.*_state_dict_from_flax``; the inputs come
from numpy seeds. The reference's models compute in bf16 by default;
these tests run both sides in float32 (``compute_dtype``), as the DeepFM
tests do. Forward logits and grads (params and the pooled input) within
rtol 1e-5 / atol 1e-6 (float32 GEMMs in another order); two
``Trainer`` passes in the ragged train-state class, rtol 2e-4 / atol
2e-5, rows assigned exactly, and the AUC within 2e-4: over 192 instances
(96 positive) one prediction that a last-bit difference moves across an
AUC bucket boundary moves the AUC by up to 1 / (96 · 96) = 1.1e-4.
"""

import flax.linen as fnn
import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from paddlebox_tpu import models as jmodels
from paddlebox_tpu.data.dataset import InMemoryDataset as JDataset
from paddlebox_tpu.data.record import SlotRecord as JRecord
from paddlebox_tpu.ps import EmbeddingTable as JTable
from paddlebox_tpu.ps import SparseSGDConfig as JCfg
from paddlebox_tpu.train import Trainer as JTrainer

from paddlebox_tpu_torch import EmbeddingTable, InMemoryDataset, Trainer
from paddlebox_tpu_torch import convert, models
from paddlebox_tpu_torch.data import SlotRecord
from paddlebox_tpu_torch.ps import table as ttable

from test_torch_train import (BS, CAP, CFG, DENSE, MF, S, STATE_ATOL,
                              STATE_RTOL, _descs, _jax_logical,
                              _port_logical, _ragged_arrays)

F32 = jnp.float32
W = 3 + MF                      # pooled width a slot


class _JMMoESingleF32(fnn.Module):
    """The reference's MMoESingle with a float32 MMoE (its own wrapper
    fixes the MMoE's bf16 default)."""

    expert_hidden: tuple = (16, 8)
    tower_hidden: tuple = (8,)

    @fnn.compact
    def __call__(self, pooled, dense):
        return jmodels.MMoE(3, 2, self.expert_hidden, self.tower_hidden,
                            compute_dtype=F32, name="mmoe")(pooled,
                                                            dense)[:, 0]


# name → (flax module, port module, converter)
MODELS = {
    "ctr_dnn": (lambda: jmodels.CtrDnn(hidden=(16, 8), compute_dtype=F32),
                lambda: models.CtrDnn(S, W, DENSE, hidden=(16, 8),
                                      compute_dtype=torch.float32),
                convert.ctr_dnn_state_dict_from_flax),
    "wide_deep": (lambda: jmodels.WideDeep(hidden=(16, 8),
                                           compute_dtype=F32),
                  lambda: models.WideDeep(S, W, DENSE, hidden=(16, 8),
                                          compute_dtype=torch.float32),
                  convert.wide_deep_state_dict_from_flax),
    "dcn_parallel": (lambda: jmodels.DCNv2(hidden=(16, 8),
                                           compute_dtype=F32),
                     lambda: models.DCNv2(S, W, DENSE, hidden=(16, 8),
                                          compute_dtype=torch.float32),
                     convert.dcn_v2_state_dict_from_flax),
    "dcn_stacked": (lambda: jmodels.DCNv2(num_cross_layers=2, hidden=(12,),
                                          compute_dtype=F32,
                                          structure="stacked"),
                    lambda: models.DCNv2(S, W, DENSE, num_cross_layers=2,
                                         hidden=(12,),
                                         compute_dtype=torch.float32,
                                         structure="stacked"),
                    convert.dcn_v2_state_dict_from_flax),
    "mmoe": (lambda: jmodels.MMoE(3, 2, (16, 8), (8,), compute_dtype=F32),
             lambda: models.MMoE(S, W, DENSE, 3, 2, (16, 8), (8,),
                                 compute_dtype=torch.float32),
             convert.mmoe_state_dict_from_flax),
    "mmoe_single": (_JMMoESingleF32,
                    lambda: models.MMoESingle(S, W, DENSE, 3, 2, (16, 8),
                                              (8,),
                                              compute_dtype=torch.float32),
                    convert.mmoe_state_dict_from_flax),
}


def _inputs(b=6, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, S, W)).astype(np.float32),
            rng.normal(size=(b, DENSE)).astype(np.float32))


@pytest.mark.parametrize("name", sorted(MODELS))
def test_forward_and_grads_match_flax(name):
    jm_f, tm_f, conv = MODELS[name]
    jm, tm = jm_f(), tm_f()
    pooled, dense = _inputs(seed=len(name))
    params = jm.init(jax.random.PRNGKey(1), jnp.asarray(pooled),
                     jnp.asarray(dense))
    sd = conv(jax.device_get(params))
    tm.load_state_dict(sd)                  # strict: every name maps
    w = np.random.default_rng(7).normal(
        size=jm.apply(params, pooled, dense).shape).astype(np.float32)

    def loss(p, x):
        return jnp.sum(jm.apply(p, x, jnp.asarray(dense)) * w)

    jout = np.asarray(jm.apply(params, pooled, dense))
    jg_p, jg_x = jax.grad(loss, argnums=(0, 1))(params, jnp.asarray(pooled))
    x = torch.from_numpy(pooled).requires_grad_(True)
    out = tm(x, torch.from_numpy(dense))
    np.testing.assert_allclose(out.detach().numpy(), jout, rtol=1e-5,
                               atol=1e-6)
    (out * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(jg_x), rtol=1e-5,
                               atol=1e-6)
    want = conv(jax.device_get(jg_p))
    for k, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[k].numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=k)


def test_registry_matches_reference():
    assert set(models.MODEL_REGISTRY) == set(jmodels.MODEL_REGISTRY)
    for key, cls in models.MODEL_REGISTRY.items():
        assert cls.__name__ == jmodels.MODEL_REGISTRY[key].__name__
        if key != "ads_rank":
            out = cls(S, W, DENSE)(torch.zeros(2, S, W), torch.zeros(2, DENSE))
            assert out.shape == (2,) and out.dtype == torch.float32


def test_bf16_default_runs_and_dcn_rejects_structure():
    pooled, dense = (torch.from_numpy(a) for a in _inputs())
    for cls in (models.CtrDnn, models.WideDeep, models.DCNv2,
                models.MMoESingle):
        out = cls(S, W, DENSE)(pooled, dense)
        assert out.dtype == torch.float32 and torch.isfinite(out).all()
    with pytest.raises(ValueError, match="structure"):
        models.DCNv2(S, W, DENSE, structure="diagonal")


# ---------------------------------------------------------------------------
# two Trainer passes against the reference's Trainer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["dcn_parallel", "mmoe_single"])
def test_two_pass_training_matches_jax_trainer(name):
    jm_f, tm_f, conv = MODELS[name]
    arrs = _ragged_arrays(n=192, seed=5)
    jdesc, tdesc = _descs()
    jt = JTable(mf_dim=MF, capacity=CAP, cfg=JCfg(**CFG),
                unique_bucket_min=512)
    jtr = JTrainer(jm_f(), jt, jdesc, tx=optax.adam(1e-2), seed=3)
    params0 = jax.device_get(jtr.state.params)
    jds = JDataset(jdesc)
    jds.records = [JRecord(k, o, d, l, 1.0, l) for k, o, d, l in arrs]
    jres = [jtr.train_pass(jds) for _ in range(2)]
    jkeys, jrows, jblob = _jax_logical(jtr)
    jparams = conv(jax.device_get(jtr.state.params))

    model = tm_f()
    model.load_state_dict(conv(params0))
    tt = EmbeddingTable(mf_dim=MF, capacity=CAP,
                        cfg=ttable.SparseSGDConfig(**CFG),
                        unique_bucket_min=512, device="cpu")
    tr = Trainer(model, tt, tdesc,
                 tx=lambda p: torch.optim.Adam(p, lr=1e-2, eps=1e-8),
                 seed=3, device="cpu")
    ds = InMemoryDataset(tdesc)
    ds.records = [SlotRecord(k, o, d, l, 1.0, l) for k, o, d, l in arrs]
    tres = [tr.train_pass(ds) for _ in range(2)]
    tkeys, trows, tblob = _port_logical(tt)
    np.testing.assert_array_equal(tkeys, jkeys)
    np.testing.assert_array_equal(trows, jrows)
    for f in sorted(jblob):
        np.testing.assert_allclose(tblob[f], jblob[f], rtol=STATE_RTOL,
                                   atol=STATE_ATOL, err_msg=f)
    sd = tr.model.state_dict()
    for k, want in jparams.items():
        np.testing.assert_allclose(sd[k].numpy(), want.numpy(),
                                   rtol=STATE_RTOL, atol=STATE_ATOL,
                                   err_msg=k)
    for j, t in zip(jres, tres):
        assert t["batches"] == j["batches"] == len(arrs) // BS
        np.testing.assert_allclose(t["auc"], j["auc"], rtol=0, atol=2e-4)
