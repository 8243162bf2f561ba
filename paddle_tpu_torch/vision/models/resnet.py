"""The ResNet family (reference: ``paddle_tpu/vision/models/resnet.py``:
``BasicBlock``, ``BottleneckBlock``, ``ResNet``, ``ResNeXt`` and the
constructors ``resnet18`` through ``wide_resnet101_2``, lines 1-232).

The same modules and parameter names as the reference, NCHW: a 7 x 7
stride-2 ``Conv2D`` stem without bias, ``BatchNorm2D``, ReLU and a 3 x 3
stride-2 max pool; four stages of blocks (a 1 x 1 ``Conv2D`` +
``BatchNorm2D`` downsample where the stride or the width changes);
global average pooling, ``flatten(1)`` and the ``Linear`` classifier.
ResNeXt's grouped 3 x 3 convolutions are ``F.conv2d(groups=)``; the wide
ResNets widen the bottleneck (``width``). Every op of the path is a cast
point of ``amp`` under the reference's op name, the residual ``out +
identity`` (``paddle_tpu_torch.tensor.add``, the reference's Tensor
``+``) and ``x.flatten(1)`` (``tensor.flatten``) included, so under
``auto_cast`` the model casts where the reference casts: under O2 the
convolutions run in bf16, the batch norms' outputs are fp32 (black
list), ReLU casts them back to bf16 and the loss runs in fp32.

Parameters are drawn from ``np.random.RandomState(seed)`` in the
layers' creation order (``nn/layer/conv.py``, ``nn/layer/common.py``):
not the reference's draws, so weights are carried across with
``models/convert.py`` ``dense_state_dict_from_numpy``. ``pretrained``
raises, as in the reference: no weights are bundled.

Numerics: each forward enters the GEMM settings of the parameters'
dtype (``framework/precision.py``: TF32 off for fp32 convolutions and
the classifier), and so does the backward pass that starts from the
output, through one identity node on it (``backward_precision``); each
convolution also enters its operands' settings itself
(``nn/functional/conv.py``).
"""
from __future__ import annotations

import numpy as np
from torch import nn

from ... import tensor as T
from ...framework.device import resolve_device
from ...framework.precision import (backward_precision, matmul_precision,
                                    settings_for)
from ...nn import (AdaptiveAvgPool2D, BatchNorm2D, Conv2D, Linear, MaxPool2D,
                   ReLU, Sequential)

__all__ = [
    "BasicBlock", "BottleneckBlock", "ResNet", "ResNeXt", "resnet18",
    "resnet34", "resnet50", "resnet101", "resnet152", "resnext50_32x4d",
    "resnext50_64x4d", "resnext101_32x4d", "resnext101_64x4d",
    "resnext152_32x4d", "resnext152_64x4d", "wide_resnet50_2",
    "wide_resnet101_2",
]


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, inplanes, planes, stride=1, downsample=None, groups=1,
                 base_width=64, dilation=1, norm_layer=None, *,
                 device="cuda", rs=None):
        super().__init__()
        kw = dict(device=device)
        norm_layer = norm_layer or BatchNorm2D
        if dilation > 1:
            raise NotImplementedError(
                "dilation > 1 not supported in BasicBlock")
        self.conv1 = Conv2D(inplanes, planes, 3, padding=1, stride=stride,
                            bias_attr=False, rs=rs, **kw)
        self.bn1 = norm_layer(planes, **kw)
        self.relu = ReLU()
        self.conv2 = Conv2D(planes, planes, 3, padding=1, bias_attr=False,
                            rs=rs, **kw)
        self.bn2 = norm_layer(planes, **kw)
        self.downsample = downsample
        self.stride = stride

    def forward(self, x):
        identity = x
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        if self.downsample is not None:
            identity = self.downsample(x)
        return self.relu(T.add(out, identity))


class BottleneckBlock(nn.Module):
    expansion = 4

    def __init__(self, inplanes, planes, stride=1, downsample=None, groups=1,
                 base_width=64, dilation=1, norm_layer=None, *,
                 device="cuda", rs=None):
        super().__init__()
        kw = dict(device=device)
        norm_layer = norm_layer or BatchNorm2D
        width = int(planes * (base_width / 64.0)) * groups
        self.conv1 = Conv2D(inplanes, width, 1, bias_attr=False, rs=rs, **kw)
        self.bn1 = norm_layer(width, **kw)
        self.conv2 = Conv2D(width, width, 3, padding=dilation, stride=stride,
                            groups=groups, dilation=dilation,
                            bias_attr=False, rs=rs, **kw)
        self.bn2 = norm_layer(width, **kw)
        self.conv3 = Conv2D(width, planes * self.expansion, 1,
                            bias_attr=False, rs=rs, **kw)
        self.bn3 = norm_layer(planes * self.expansion, **kw)
        self.relu = ReLU()
        self.downsample = downsample
        self.stride = stride

    def forward(self, x):
        identity = x
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        if self.downsample is not None:
            identity = self.downsample(x)
        return self.relu(T.add(out, identity))


class ResNet(nn.Module):
    """ResNet from "Deep Residual Learning for Image Recognition".

    Args:
        block: BasicBlock or BottleneckBlock.
        depth: 18/34/50/101/152.
        width: base width of each block group (64 for classic resnets).
        num_classes: classifier size; <= 0 drops the fc head.
        with_pool: keep the global average pool.
        groups: cardinality (ResNeXt).
        seed: the parameters' ``RandomState`` seed.
        device: where the parameters live ("cuda" unless "cpu").
    """

    def __init__(self, block, depth=50, width=64, num_classes=1000,
                 with_pool=True, groups=1, *, seed=0, device="cuda"):
        super().__init__()
        layers = {18: [2, 2, 2, 2], 34: [3, 4, 6, 3], 50: [3, 4, 6, 3],
                  101: [3, 4, 23, 3], 152: [3, 8, 36, 3]}[depth]
        self.device = resolve_device(device)
        self._rs = np.random.RandomState(seed)
        kw = dict(device=self.device)
        self.groups = groups
        self.base_width = width
        self.num_classes = num_classes
        self.with_pool = with_pool
        self._norm_layer = BatchNorm2D
        self.inplanes = 64
        self.dilation = 1

        self.conv1 = Conv2D(3, self.inplanes, kernel_size=7, stride=2,
                            padding=3, bias_attr=False, rs=self._rs, **kw)
        self.bn1 = self._norm_layer(self.inplanes, **kw)
        self.relu = ReLU()
        self.maxpool = MaxPool2D(kernel_size=3, stride=2, padding=1)
        self.layer1 = self._make_layer(block, 64, layers[0])
        self.layer2 = self._make_layer(block, 128, layers[1], stride=2)
        self.layer3 = self._make_layer(block, 256, layers[2], stride=2)
        self.layer4 = self._make_layer(block, 512, layers[3], stride=2)
        if with_pool:
            self.avgpool = AdaptiveAvgPool2D((1, 1))
        if num_classes > 0:
            self.fc = Linear(512 * block.expansion, num_classes,
                             rs=self._rs, **kw)
        del self._rs

    def _make_layer(self, block, planes, blocks, stride=1, dilate=False):
        norm_layer = self._norm_layer
        kw = dict(device=self.device)
        downsample = None
        previous_dilation = self.dilation
        if dilate:
            self.dilation *= stride
            stride = 1
        if stride != 1 or self.inplanes != planes * block.expansion:
            downsample = Sequential(
                Conv2D(self.inplanes, planes * block.expansion, 1,
                       stride=stride, bias_attr=False, rs=self._rs, **kw),
                norm_layer(planes * block.expansion, **kw),
            )
        layers = [block(self.inplanes, planes, stride, downsample,
                        self.groups, self.base_width, previous_dilation,
                        norm_layer, rs=self._rs, **kw)]
        self.inplanes = planes * block.expansion
        for _ in range(1, blocks):
            layers.append(block(self.inplanes, planes, groups=self.groups,
                                base_width=self.base_width,
                                norm_layer=norm_layer, rs=self._rs, **kw))
        return Sequential(*layers)

    def forward(self, x):
        settings = settings_for(self.conv1._parameters["weight"].dtype)
        with matmul_precision(settings):
            x = self.maxpool(self.relu(self.bn1(self.conv1(x))))
            x = self.layer4(self.layer3(self.layer2(self.layer1(x))))
            if self.with_pool:
                x = self.avgpool(x)
            if self.num_classes > 0:
                x = T.flatten(x, 1)
                x = self.fc(x)
        return backward_precision(settings, x)


def _resnet(arch, Block, depth, pretrained, **kwargs):
    if pretrained:
        raise ValueError(
            "pretrained weights are not bundled with paddle_tpu_torch (no "
            "model hub in this environment); load a converted state_dict "
            "(models/convert.py dense_state_dict_from_numpy) instead")
    return ResNet(Block, depth, **kwargs)


def resnet18(pretrained=False, **kwargs):
    return _resnet("resnet18", BasicBlock, 18, pretrained, **kwargs)


def resnet34(pretrained=False, **kwargs):
    return _resnet("resnet34", BasicBlock, 34, pretrained, **kwargs)


def resnet50(pretrained=False, **kwargs):
    return _resnet("resnet50", BottleneckBlock, 50, pretrained, **kwargs)


def resnet101(pretrained=False, **kwargs):
    return _resnet("resnet101", BottleneckBlock, 101, pretrained, **kwargs)


def resnet152(pretrained=False, **kwargs):
    return _resnet("resnet152", BottleneckBlock, 152, pretrained, **kwargs)


def resnext50_32x4d(pretrained=False, **kwargs):
    kwargs.update(groups=32, width=4)
    return _resnet("resnext50_32x4d", BottleneckBlock, 50, pretrained,
                   **kwargs)


def resnext50_64x4d(pretrained=False, **kwargs):
    kwargs.update(groups=64, width=4)
    return _resnet("resnext50_64x4d", BottleneckBlock, 50, pretrained,
                   **kwargs)


def resnext101_32x4d(pretrained=False, **kwargs):
    kwargs.update(groups=32, width=4)
    return _resnet("resnext101_32x4d", BottleneckBlock, 101, pretrained,
                   **kwargs)


def resnext101_64x4d(pretrained=False, **kwargs):
    kwargs.update(groups=64, width=4)
    return _resnet("resnext101_64x4d", BottleneckBlock, 101, pretrained,
                   **kwargs)


def resnext152_32x4d(pretrained=False, **kwargs):
    kwargs.update(groups=32, width=4)
    return _resnet("resnext152_32x4d", BottleneckBlock, 152, pretrained,
                   **kwargs)


def resnext152_64x4d(pretrained=False, **kwargs):
    kwargs.update(groups=64, width=4)
    return _resnet("resnext152_64x4d", BottleneckBlock, 152, pretrained,
                   **kwargs)


def wide_resnet50_2(pretrained=False, **kwargs):
    kwargs["width"] = 64 * 2
    return _resnet("wide_resnet50_2", BottleneckBlock, 50, pretrained,
                   **kwargs)


def wide_resnet101_2(pretrained=False, **kwargs):
    kwargs["width"] = 64 * 2
    return _resnet("wide_resnet101_2", BottleneckBlock, 101, pretrained,
                   **kwargs)


class ResNeXt(ResNet):
    """Aggregated residual transformations: a ResNet of BottleneckBlocks
    with grouped 3 x 3 convolutions, ``depth`` picking the layout and
    ``cardinality`` the group count."""

    def __init__(self, depth=50, cardinality=32, num_classes=1000,
                 with_pool=True, **kwargs):
        super().__init__(BottleneckBlock, depth=depth, width=4,
                         num_classes=num_classes, with_pool=with_pool,
                         groups=cardinality, **kwargs)
