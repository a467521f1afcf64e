"""paddlebox_tpu_torch — the PyTorch/CUDA port of paddlebox_tpu for an
NVIDIA H100.

It imports ``torch`` and ``numpy`` only, never jax or the JAX package.
Entry points run on the card (``device="cuda"``) unless the caller asks
for the CPU; on the CPU every kernel wrapper takes its plain PyTorch
version.
"""

from paddlebox_tpu_torch.artifacts import (ArtifactCorruptError,
                                           ArtifactHandle,
                                           ArtifactLeaseLostError,
                                           ArtifactLineageError,
                                           ArtifactStore, Lease,
                                           LeaseRegistry)
from paddlebox_tpu_torch.data.dataset import (DatasetFactory,
                                              InMemoryDataset,
                                              PaddleBoxDataset, QueueDataset)
from paddlebox_tpu_torch.metrics import MetricRegistry
from paddlebox_tpu_torch.models.ads_rank import AdsRank
from paddlebox_tpu_torch.models.deepfm import DeepFM
from paddlebox_tpu_torch.ps.table import EmbeddingTable
from paddlebox_tpu_torch.serving import ReloadLoop, ServingModel
from paddlebox_tpu_torch.train.checkpoint import (CheckpointManager,
                                                  adopt_artifact,
                                                  state_digest)
from paddlebox_tpu_torch.train.step import TrainStep
from paddlebox_tpu_torch.train.trainer import Trainer

__all__ = ["AdsRank", "ArtifactCorruptError", "ArtifactHandle",
           "ArtifactLeaseLostError", "ArtifactLineageError",
           "ArtifactStore", "CheckpointManager", "DatasetFactory", "DeepFM",
           "EmbeddingTable", "InMemoryDataset", "Lease", "LeaseRegistry",
           "MetricRegistry", "PaddleBoxDataset", "QueueDataset",
           "ReloadLoop", "ServingModel", "TrainStep", "Trainer",
           "adopt_artifact", "state_digest"]
