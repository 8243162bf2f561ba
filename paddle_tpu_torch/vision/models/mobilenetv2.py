"""MobileNetV2 (reference: ``paddle_tpu/vision/models/mobilenetv2.py``),
written as LeNet's port is: ``nn.Layer``s built from ``nn.Sequential``,
``Conv2D`` (depthwise through ``groups``), ``BatchNorm2D``, ``ReLU6``,
``AdaptiveAvgPool2D``, ``Dropout(0.2)`` and ``Linear``, the parameters
from the layers' default initializers (the global stream:
``paddle.seed``). Sandler et al. 2018's network: a stride-2 stem, 17
inverted residual blocks (a 1 x 1 expansion by ``t``, a 3 x 3 depthwise
convolution, a linear 1 x 1 projection; the residual where the stride
is 1 and the width is kept), a 1 x 1 head to 1280 channels (times
``scale`` above 1) and the classifier. It runs on eager ``Tensor``s
and plain ``torch.Tensor``s alike.
"""
from __future__ import annotations

from ... import nn

__all__ = ["MobileNetV2", "mobilenet_v2"]


def _make_divisible(v, divisor=8, min_value=None):
    if min_value is None:
        min_value = divisor
    new_v = max(min_value, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


class ConvBNReLU(nn.Sequential):
    def __init__(self, in_planes, out_planes, kernel_size=3, stride=1,
                 groups=1):
        padding = (kernel_size - 1) // 2
        super().__init__(
            nn.Conv2D(in_planes, out_planes, kernel_size, stride, padding,
                      groups=groups, bias_attr=False),
            nn.BatchNorm2D(out_planes),
            nn.ReLU6(),
        )


class InvertedResidual(nn.Layer):
    def __init__(self, inp, oup, stride, expand_ratio):
        super().__init__()
        self.stride = stride
        hidden_dim = int(round(inp * expand_ratio))
        self.use_res_connect = self.stride == 1 and inp == oup
        layers = []
        if expand_ratio != 1:
            layers.append(ConvBNReLU(inp, hidden_dim, kernel_size=1))
        layers.extend([
            ConvBNReLU(hidden_dim, hidden_dim, stride=stride,
                       groups=hidden_dim),
            nn.Conv2D(hidden_dim, oup, 1, 1, 0, bias_attr=False),
            nn.BatchNorm2D(oup),
        ])
        self.conv = nn.Sequential(*layers)

    def forward(self, x):
        if self.use_res_connect:
            return x + self.conv(x)
        return self.conv(x)


class MobileNetV2(nn.Layer):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True):
        super().__init__()
        self.num_classes = num_classes
        self.with_pool = with_pool
        input_channel = 32
        last_channel = 1280
        inverted_residual_setting = [
            [1, 16, 1, 1], [6, 24, 2, 2], [6, 32, 3, 2], [6, 64, 4, 2],
            [6, 96, 3, 1], [6, 160, 3, 2], [6, 320, 1, 1],
        ]
        input_channel = _make_divisible(input_channel * scale)
        self.last_channel = _make_divisible(last_channel * max(1.0, scale))
        features = [ConvBNReLU(3, input_channel, stride=2)]
        for t, c, n, s in inverted_residual_setting:
            output_channel = _make_divisible(c * scale)
            for i in range(n):
                features.append(InvertedResidual(
                    input_channel, output_channel, s if i == 0 else 1,
                    expand_ratio=t))
                input_channel = output_channel
        features.append(ConvBNReLU(input_channel, self.last_channel,
                                   kernel_size=1))
        self.features = nn.Sequential(*features)
        if with_pool:
            self.pool2d_avg = nn.AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.classifier = nn.Sequential(
                nn.Dropout(0.2), nn.Linear(self.last_channel, num_classes))

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.pool2d_avg(x)
        if self.num_classes > 0:
            x = self.classifier(x.flatten(1))
        return x


def mobilenet_v2(pretrained=False, scale=1.0, **kwargs):
    if pretrained:
        raise ValueError("pretrained weights not bundled; use "
                         "set_state_dict")
    return MobileNetV2(scale=scale, **kwargs)
