from paddlebox_tpu_torch.models.deepfm import DeepFM

__all__ = ["DeepFM"]
