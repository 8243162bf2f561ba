"""Vision models (reference: ``paddle_tpu/vision/models/__init__.py``):
the ResNet family and LeNet."""
from .lenet import LeNet
from .resnet import (BasicBlock, BottleneckBlock, ResNet, ResNeXt, resnet18,
                     resnet34, resnet50, resnet101, resnet152,
                     resnext50_32x4d, resnext50_64x4d, resnext101_32x4d,
                     resnext101_64x4d, resnext152_32x4d, resnext152_64x4d,
                     wide_resnet50_2, wide_resnet101_2)

__all__ = ["BasicBlock", "BottleneckBlock", "LeNet", "ResNet", "ResNeXt",
           "resnet18", "resnet34", "resnet50", "resnet101", "resnet152",
           "resnext50_32x4d", "resnext50_64x4d", "resnext101_32x4d",
           "resnext101_64x4d", "resnext152_32x4d", "resnext152_64x4d",
           "wide_resnet50_2", "wide_resnet101_2"]
