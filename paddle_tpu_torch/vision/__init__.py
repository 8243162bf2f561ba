"""Vision models of the port (reference: ``paddle_tpu/vision``): the
ResNet family (``vision/models/resnet.py``), LeNet
(``vision/models/lenet.py``) and MobileNetV2
(``vision/models/mobilenetv2.py``); the other models, datasets
and transforms are not ported yet (ROADMAP Queue A 14)."""
from . import models

__all__ = ["models"]
