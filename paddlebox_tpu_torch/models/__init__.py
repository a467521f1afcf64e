from paddlebox_tpu_torch.models.ads_rank import AdsRank
from paddlebox_tpu_torch.models.deepfm import DeepFM

__all__ = ["AdsRank", "DeepFM"]
