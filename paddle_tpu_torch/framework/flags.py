"""Flags (reference: ``paddle_tpu/framework/flags.py``).

Only the flags the port reads (serving and its replica set, request
tracing, the telemetry endpoint and the flight recorder, the loss
scaler's floor, the parameter server's communicator and its RPC
profiler), with the reference's defaults. An environment variable of
the same name overrides a default when this module is first imported,
as in the reference. ``FLAGS_enable_rpc_profiler`` is wired as the
reference wires it: setting it (or its environment variable) turns the
per-RPC event log of ``observability.enable_rpc_event_log`` on or off.
"""
from __future__ import annotations

import os
from typing import Any, Dict

__all__ = ["flag", "set_flags", "get_flags"]

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
    # per-replica watchdog: a scheduler tick stuck past this many seconds
    # evicts the replica (drain + re-admit its in-flight requests)
    "FLAGS_serving_watchdog_s": 30.0,
    # draft tokens proposed per speculative decode step
    "FLAGS_serving_spec_k": 4,
    # while a replica reports "compiling" its watchdog deadline stretches
    # to this many seconds
    "FLAGS_serving_compile_grace_s": 120.0,
    # request-scoped tracing: spans into the bounded trace store and the
    # flight recorder, trace ids as latency-histogram exemplars
    "FLAGS_serving_tracing": True,
    # bounded trace store: traces kept (oldest evicted), spans per trace
    "FLAGS_trace_store_capacity": 256,
    "FLAGS_trace_max_spans": 256,
    # wall-clock budget of a warm replica boot before the cold fallback
    "FLAGS_replica_boot_budget_s": 300.0,
    # telemetry HTTP endpoint of start_exposition(); 0 = off
    "FLAGS_telemetry_http_port": 0,
    # flight-recorder ring depth (0 disables it) and dump directory
    # ("" = <tmpdir>/paddle_tpu_flightrec)
    "FLAGS_flight_recorder_capacity": 4096,
    "FLAGS_flight_recorder_dir": "",
    # GradScaler never shrinks the loss scale below this
    "FLAGS_min_loss_scaling": 1.0,
    # PS communicator: read as defaults by Communicator.create and
    # AsyncCommunicator (merge window, queue depth in windows, send wait)
    "FLAGS_communicator_max_merge_var_num": 20,
    "FLAGS_communicator_send_queue_size": 20,
    "FLAGS_communicator_send_wait_times": 0.005,
    # on: PS pushes and pulls write a per-RPC event-log record
    # (distributed/ps/communicator.py)
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


def _apply_rpc_profiler(on: bool) -> None:
    from ..observability import enable_rpc_event_log

    enable_rpc_event_log(on)


def set_flags(flags: Dict[str, Any]) -> None:
    """Set flags by name (``paddle.set_flags``); an unknown name raises."""
    unknown = sorted(set(flags) - set(_FLAGS))
    if unknown:
        raise KeyError(f"unknown flags {unknown}")
    _FLAGS.update(flags)
    if "FLAGS_enable_rpc_profiler" in flags:
        _apply_rpc_profiler(bool(flags["FLAGS_enable_rpc_profiler"]))


def get_flags(flags) -> Dict[str, Any]:
    """``paddle.get_flags``: the values of the named flags (None for a
    name the port does not read)."""
    if isinstance(flags, str):
        flags = [flags]
    return {k: _FLAGS.get(k) for k in flags}
