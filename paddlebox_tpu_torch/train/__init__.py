from paddlebox_tpu_torch.train.checkpoint import (CheckpointCorruptError,
                                                  CheckpointManager,
                                                  adopt_artifact,
                                                  state_digest)
from paddlebox_tpu_torch.train.device_pass import (PassPipeline,
                                                   PassPreloader,
                                                   PreloadBuildAborted,
                                                   ResidentPass,
                                                   ResidentPassRunner)
from paddlebox_tpu_torch.train.multi_mf_sharded import (
    MultiMfShardedTrainer, MultiMfShardedTrainStep)
from paddlebox_tpu_torch.train.multi_mf_step import (MultiMfResidentPass,
                                                     MultiMfTrainer,
                                                     MultiMfTrainStep)
from paddlebox_tpu_torch.train.step import (DeviceBatch, StepState,
                                            TrainStep, ctr_forward,
                                            make_device_batch)
from paddlebox_tpu_torch.train.trainer import NanInfError, Trainer

__all__ = ["CheckpointCorruptError", "CheckpointManager", "DeviceBatch",
           "MultiMfResidentPass", "MultiMfShardedTrainStep",
           "MultiMfShardedTrainer", "MultiMfTrainStep", "MultiMfTrainer",
           "NanInfError", "PassPipeline", "PassPreloader",
           "PreloadBuildAborted", "ResidentPass", "ResidentPassRunner",
           "StepState", "TrainStep", "Trainer", "adopt_artifact",
           "ctr_forward", "make_device_batch", "state_digest"]
