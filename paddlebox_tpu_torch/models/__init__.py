from paddlebox_tpu_torch.models.ads_rank import AdsRank
from paddlebox_tpu_torch.models.ctr_dnn import CtrDnn
from paddlebox_tpu_torch.models.dcn import CrossLayer, DCNv2
from paddlebox_tpu_torch.models.deepfm import DeepFM
from paddlebox_tpu_torch.models.mmoe import MMoE, MMoESingle
from paddlebox_tpu_torch.models.wide_deep import WideDeep

# the reference's registry: every entry but AdsRank takes (num_slots,
# slot_width, dense_dim, ...) and maps (pooled, dense) → logits [B]
MODEL_REGISTRY = {
    "ctr_dnn": CtrDnn,
    "deepfm": DeepFM,
    "wide_deep": WideDeep,
    "dcn_v2": DCNv2,
    "ads_rank": AdsRank,
    "mmoe": MMoESingle,
}

__all__ = ["AdsRank", "CrossLayer", "CtrDnn", "DCNv2", "DeepFM", "MMoE",
           "MMoESingle", "MODEL_REGISTRY", "WideDeep"]
