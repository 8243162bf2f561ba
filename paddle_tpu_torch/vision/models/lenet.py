"""LeNet (reference: ``paddle_tpu/vision/models/lenet.py``), written as a
Paddle user writes a model: a subclass of ``nn.Layer`` built from
``nn.Sequential``, ``Conv2D``, ``ReLU``, ``MaxPool2D`` and ``Linear``,
its parameters from the layers' default initializers (the global
stream: ``paddle.seed``). It runs on eager ``Tensor``s (``x.flatten(1)``
is the eager ``Tensor`` method) and on plain ``torch.Tensor``s alike.
"""
from __future__ import annotations

from ... import nn

__all__ = ["LeNet"]


class LeNet(nn.Layer):
    """LeNet for 1 x 28 x 28 inputs (MNIST)."""

    def __init__(self, num_classes=10):
        super().__init__()
        self.num_classes = num_classes
        self.features = nn.Sequential(
            nn.Conv2D(1, 6, 3, stride=1, padding=1),
            nn.ReLU(),
            nn.MaxPool2D(2, 2),
            nn.Conv2D(6, 16, 5, stride=1, padding=0),
            nn.ReLU(),
            nn.MaxPool2D(2, 2),
        )
        if num_classes > 0:
            self.fc = nn.Sequential(
                nn.Linear(400, 120),
                nn.Linear(120, 84),
                nn.Linear(84, num_classes),
            )

    def forward(self, inputs):
        x = self.features(inputs)
        if self.num_classes > 0:
            x = x.flatten(1)
            x = self.fc(x)
        return x
