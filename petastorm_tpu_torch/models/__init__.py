"""Consumer models of the ingest feed."""

from petastorm_tpu_torch.models.mlp import MLP
from petastorm_tpu_torch.models.resnet import ResNet, ResNet50

__all__ = ["MLP", "ResNet", "ResNet50"]
