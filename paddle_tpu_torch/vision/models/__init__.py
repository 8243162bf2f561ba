"""Vision models (reference: ``paddle_tpu/vision/models/__init__.py``):
the ResNet family, LeNet and MobileNetV2."""
from .lenet import LeNet
from .mobilenetv2 import MobileNetV2, mobilenet_v2
from .resnet import (BasicBlock, BottleneckBlock, ResNet, ResNeXt, resnet18,
                     resnet34, resnet50, resnet101, resnet152,
                     resnext50_32x4d, resnext50_64x4d, resnext101_32x4d,
                     resnext101_64x4d, resnext152_32x4d, resnext152_64x4d,
                     wide_resnet50_2, wide_resnet101_2)

__all__ = ["BasicBlock", "BottleneckBlock", "LeNet", "MobileNetV2",
           "ResNet", "ResNeXt", "mobilenet_v2",
           "resnet18", "resnet34", "resnet50", "resnet101", "resnet152",
           "resnext50_32x4d", "resnext50_64x4d", "resnext101_32x4d",
           "resnext101_64x4d", "resnext152_32x4d", "resnext152_64x4d",
           "wide_resnet50_2", "wide_resnet101_2"]
