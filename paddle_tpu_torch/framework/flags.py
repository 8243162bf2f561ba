"""Flags (reference: ``paddle_tpu/framework/flags.py``).

Only the flags the port reads (serving, and the loss scaler's floor),
with the reference's defaults. An environment variable of the same name overrides a default
when this module is first imported, as in the reference.
"""
from __future__ import annotations

import os
from typing import Any, Dict

__all__ = ["flag"]

_FLAGS: Dict[str, Any] = {
    # tokens per paged-KV-cache block (the pool allocation granularity)
    "FLAGS_serving_block_tokens": 16,
    # max sequences decoded together per engine (the continuous batch)
    "FLAGS_serving_max_batch": 8,
    # request-queue admission depth: submits beyond this are rejected
    "FLAGS_serving_queue_depth": 256,
    # at-rest KV codec: "fp32" | "int8_block" | "fp8_block"
    "FLAGS_serving_kv_codec": "fp32",
    # prefill only the prompt tail not already held by shared KV blocks
    "FLAGS_serving_prefix_cache": True,
    # GradScaler never shrinks the loss scale below this
    "FLAGS_min_loss_scaling": 1.0,
}


def _parse(cur, v: str):
    if isinstance(cur, bool):
        return v.lower() in ("1", "true", "yes")
    if isinstance(cur, int):
        return int(v)
    if isinstance(cur, float):
        return float(v)
    return v


for _k in _FLAGS:
    if _k in os.environ:
        _FLAGS[_k] = _parse(_FLAGS[_k], os.environ[_k])


def flag(name: str):
    return _FLAGS[name]
