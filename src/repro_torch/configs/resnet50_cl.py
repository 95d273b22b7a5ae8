"""The paper's own model: a ResNet-50 class-incremental image classifier.

``full()`` is the published width (bottleneck blocks, stages (3, 4, 6, 3),
width 64, 224x224x3 images, 1000 classes); ``resnet18()`` and ``ghostnet()``
are the other variants at that width; ``reduced()`` is the tiny ResNet
the CPU experiments train on 32x32 synthetic images.
"""
from dataclasses import dataclass
from typing import Tuple

ARCH_ID = "resnet50-cl"


@dataclass(frozen=True)
class CNNConfig:
    name: str
    variant: str  # resnet18 (basic) | resnet50 (bottleneck) | ghostnet (ghost blocks)
    num_classes: int = 1000
    width: int = 64
    stage_blocks: Tuple[int, ...] = (3, 4, 6, 3)
    bottleneck: bool = True
    image_size: int = 224
    channels: int = 3


def full() -> CNNConfig:
    return CNNConfig(name="resnet50-cl", variant="resnet50", stage_blocks=(3, 4, 6, 3),
                     bottleneck=True)


def resnet18() -> CNNConfig:
    return CNNConfig(name="resnet18-cl", variant="resnet18", stage_blocks=(2, 2, 2, 2),
                     bottleneck=False)


def ghostnet() -> CNNConfig:
    return CNNConfig(name="ghostnet50-cl", variant="ghostnet", stage_blocks=(2, 2, 4, 2),
                     bottleneck=False)


def reduced(num_classes: int = 40) -> CNNConfig:
    """Tiny ResNet for CPU CL experiments (32x32 synthetic images)."""
    return CNNConfig(name="resnet-tiny-cl", variant="resnet18", num_classes=num_classes,
                     width=16, stage_blocks=(1, 1, 1), bottleneck=False, image_size=32)
