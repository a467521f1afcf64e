from paddlebox_tpu_torch.utils.prefetch import prefetch_iter

__all__ = ["prefetch_iter"]
