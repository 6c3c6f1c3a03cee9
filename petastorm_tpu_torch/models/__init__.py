"""Consumer models of the ingest feed."""

from petastorm_tpu_torch.models.resnet import ResNet, ResNet50

__all__ = ["ResNet", "ResNet50"]
