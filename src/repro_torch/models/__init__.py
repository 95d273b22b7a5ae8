"""Models of the port: the paper's ResNet classifiers, the dense, SSM,
mixture-of-experts and hybrid language models (``build_model``), and their
loss."""
from repro_torch.models.model_zoo import LM, build_model, cross_entropy
from repro_torch.models.resnet import CNN, apply_cnn, cnn_outputs, init_cnn
from repro_torch.models.transformer import StackCtx

__all__ = ["CNN", "LM", "StackCtx", "apply_cnn", "build_model", "cnn_outputs",
           "cross_entropy", "init_cnn"]
