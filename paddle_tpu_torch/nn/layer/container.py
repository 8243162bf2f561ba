"""Containers (reference: ``paddle_tpu/nn/layer/container.py``
``Sequential``, ``LayerList``, ``ParameterList`` and ``LayerDict``,
lines 11, 41, 81 and 102).

Sublayers are named "0", "1", ... in order, or by the names of an
``OrderedDict``, of ``(name, layer)`` pairs or of a ``LayerDict``'s
keys, so ``state_dict`` keys are the reference's (``layer1.0.conv1.weight``,
``0.weight``); a ``ParameterList``'s parameters are "0", "1", ...
"""
from __future__ import annotations

import collections

from .layers import Layer

__all__ = ["Sequential", "LayerList", "ParameterList", "LayerDict"]


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


class LayerList(Layer):
    def __init__(self, sublayers=None):
        super().__init__()
        if sublayers is not None:
            for i, layer in enumerate(sublayers):
                self.add_sublayer(str(i), layer)

    def __getitem__(self, idx):
        if isinstance(idx, slice):
            return LayerList(list(self._modules.values())[idx])
        if idx < 0:
            idx += len(self)
        return self._modules[str(idx)]

    def __setitem__(self, idx, layer):
        self._modules[str(idx)] = layer

    def __len__(self):
        return len(self._modules)

    def __iter__(self):
        return iter(self._modules.values())

    def append(self, layer):
        self.add_sublayer(str(len(self)), layer)
        return self

    def insert(self, index, layer):
        layers = list(self._modules.values())
        layers.insert(index, layer)
        self._modules.clear()
        for i, l in enumerate(layers):
            self._modules[str(i)] = l

    def extend(self, layers):
        for layer in layers:
            self.append(layer)
        return self


class ParameterList(Layer):
    def __init__(self, parameters=None):
        super().__init__()
        if parameters is not None:
            for i, p in enumerate(parameters):
                self.add_parameter(str(i), p)

    def __getitem__(self, idx):
        return getattr(self, str(idx))

    def __len__(self):
        return len(self._parameters)

    def __iter__(self):
        return (getattr(self, k) for k in self._parameters)

    def append(self, parameter):
        self.add_parameter(str(len(self)), parameter)
        return self


class LayerDict(Layer):
    def __init__(self, sublayers=None):
        super().__init__()
        if sublayers is not None:
            self.update(sublayers)

    def __getitem__(self, key):
        return self._modules[key]

    def __setitem__(self, key, layer):
        self.add_sublayer(key, layer)

    def __delitem__(self, key):
        del self._modules[key]

    def __len__(self):
        return len(self._modules)

    def __iter__(self):
        return iter(self._modules)

    def __contains__(self, key):
        return key in self._modules

    def clear(self):
        self._modules.clear()

    def pop(self, key):
        layer = self._modules[key]
        del self._modules[key]
        return layer

    def keys(self):
        return self._modules.keys()

    def items(self):
        return self._modules.items()

    def values(self):
        return self._modules.values()

    def update(self, sublayers):
        items = (sublayers.items() if isinstance(sublayers, dict)
                 else sublayers)
        for k, v in items:
            self[k] = v
        return self
