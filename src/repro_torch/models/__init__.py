"""Models of the port: the paper's ResNet classifiers and their loss."""
from repro_torch.models.model_zoo import cross_entropy
from repro_torch.models.resnet import CNN, apply_cnn, cnn_outputs, init_cnn

__all__ = ["CNN", "apply_cnn", "cnn_outputs", "cross_entropy", "init_cnn"]
