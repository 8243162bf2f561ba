"""Flags (reference: ``paddle_tpu/framework/flags.py``).

Only the flags the port reads (serving, the loss scaler's floor, the
parameter server's communicator and its RPC profiler), with the
reference's defaults. An environment variable of the same name overrides a default
when this module is first imported, as in the reference.
"""
from __future__ import annotations

import os
from typing import Any, Dict

__all__ = ["flag", "set_flags"]

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
    # PS communicator: read as defaults by Communicator.create and
    # AsyncCommunicator (merge window, queue depth in windows, send wait)
    "FLAGS_communicator_max_merge_var_num": 20,
    "FLAGS_communicator_send_queue_size": 20,
    "FLAGS_communicator_send_wait_times": 0.005,
    # the reference's per-RPC event-log record; the port has none and
    # raises when it is on (distributed/ps/communicator.py)
    "FLAGS_enable_rpc_profiler": False,
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


def set_flags(flags: Dict[str, Any]) -> None:
    """Set flags by name (``paddle.set_flags``); an unknown name raises."""
    unknown = sorted(set(flags) - set(_FLAGS))
    if unknown:
        raise KeyError(f"unknown flags {unknown}")
    _FLAGS.update(flags)
