from paddlebox_tpu_torch.train.step import (DeviceBatch, ctr_forward,
                                            make_device_batch)

__all__ = ["DeviceBatch", "ctr_forward", "make_device_batch"]
