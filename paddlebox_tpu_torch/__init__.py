"""paddlebox_tpu_torch — the PyTorch/CUDA port of paddlebox_tpu for an
NVIDIA H100.

It imports ``torch`` and ``numpy`` only, never jax or the JAX package.
Entry points run on the card (``device="cuda"``) unless the caller asks
for the CPU; on the CPU every kernel wrapper takes its plain PyTorch
version.
"""

from paddlebox_tpu_torch.data.dataset import InMemoryDataset
from paddlebox_tpu_torch.models.deepfm import DeepFM
from paddlebox_tpu_torch.ps.table import EmbeddingTable
from paddlebox_tpu_torch.serving import ServingModel
from paddlebox_tpu_torch.train.step import TrainStep
from paddlebox_tpu_torch.train.trainer import Trainer

__all__ = ["DeepFM", "EmbeddingTable", "InMemoryDataset", "ServingModel",
           "TrainStep", "Trainer"]
