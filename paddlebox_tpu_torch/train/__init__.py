from paddlebox_tpu_torch.train.device_pass import (ResidentPass,
                                                   ResidentPassRunner)
from paddlebox_tpu_torch.train.step import (DeviceBatch, StepState,
                                            TrainStep, ctr_forward,
                                            make_device_batch)
from paddlebox_tpu_torch.train.trainer import NanInfError, Trainer

__all__ = ["DeviceBatch", "NanInfError", "ResidentPass",
           "ResidentPassRunner", "StepState", "TrainStep", "Trainer",
           "ctr_forward", "make_device_batch"]
