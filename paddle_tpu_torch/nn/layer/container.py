"""Containers (reference: ``paddle_tpu/nn/layer/container.py``
``Sequential``, line 11).

Sublayers are named "0", "1", ... in order, or by the names of an
``OrderedDict`` or of ``(name, layer)`` pairs, so ``state_dict`` keys
are the reference's (``layer1.0.conv1.weight``).
"""
from __future__ import annotations

import collections

from .layers import Layer


__all__ = ["Sequential"]


class Sequential(Layer):
    def __init__(self, *layers):
        super().__init__()
        if len(layers) == 1 and isinstance(layers[0],
                                           collections.OrderedDict):
            items = list(layers[0].items())
        elif layers and isinstance(layers[0], (list, tuple)):
            items = list(layers)
        else:
            items = [(str(i), l) for i, l in enumerate(layers)]
        for name, layer in items:
            self.add_module(name, layer)

    def __getitem__(self, idx):
        mods = list(self._modules.values())
        if isinstance(idx, slice):
            return Sequential(*mods[idx])
        return mods[idx]

    def __len__(self):
        return len(self._modules)

    def forward(self, input):
        for layer in self._modules.values():
            input = layer(input)
        return input
