"""DistributedStrategy, the config object (reference:
``paddle_tpu/distributed/fleet/base/distributed_strategy.py``): the
reference's toggles and ``*_configs`` dicts with their defaults, unknown
fields and unknown sub-keys refused, and a warning the first time a
knob the reference marks as a no-op is set.

Only the object is ported: ``DataParallel(strategy=...)`` and
``grad_comm.config_from_strategy`` read it. ``fleet.init``,
``distributed_optimizer`` and the fleet-global strategy are ROADMAP
Queue A item 10 (parallelism).
"""
from __future__ import annotations

import copy
import warnings

__all__ = ["DistributedStrategy"]

_DEFAULTS = {
    # comm knobs of the reference's NCCL path, accepted for compatibility
    "fuse_all_reduce_ops": True,
    "fuse_grad_size_in_MB": 32,
    "nccl_comm_num": 1,
    "sync_nccl_allreduce": True,
    # execution
    "recompute": False,
    "recompute_configs": {"checkpoints": [], "enable_offload": False},
    "gradient_merge": False,
    "gradient_merge_configs": {"k_steps": 1, "avg": True},
    "pipeline": False,
    "pipeline_configs": {"accumulate_steps": 1, "micro_batch_size": 1,
                         "schedule_mode": "1F1B"},
    "amp": False,
    "amp_configs": {"init_loss_scaling": 32768.0, "use_pure_fp16": False,
                    "use_fp16_guard": True, "custom_white_list": [],
                    "custom_black_list": []},
    "bf16": True,
    "sharding": False,
    "sharding_configs": {"sharding_degree": 1, "stage": 1, "mp_degree": 1,
                         "dp_degree": 1, "pp_degree": 1,
                         "segment_broadcast_MB": 32, "offload": False},
    "tensor_parallel": False,
    "tensor_parallel_configs": {"tensor_parallel_degree": 1},
    "lamb": False,
    "lamb_configs": {"lamb_weight_decay": 0.01, "exclude_from_weight_decay": []},
    "lars": False,
    "lars_configs": {"lars_coeff": 0.001, "lars_weight_decay": 0.0005,
                     "epsilon": 0.0, "exclude_from_weight_decay": []},
    "dgc": False,
    "dgc_configs": {"rampup_begin_step": 0, "rampup_step": 1,
                    "sparsity": [0.999]},
    "localsgd": False,
    "localsgd_configs": {"k_steps": 1, "begin_step": 1},
    "adaptive_localsgd": False,
    "a_sync": False,
    "a_sync_configs": {"k_steps": -1},
    "asp": False,
    "fp16_allreduce": False,
    # the gradient wire (distributed/grad_comm.py, overlap.py): codec one of
    # fp32/bf16/int8/int8_block/fp8_block, bucket caps in MB, error
    # feedback, overlap, elements a scale block
    "grad_comm": False,
    "grad_comm_configs": {"codec": "bf16", "comm_buffer_size_MB": 25,
                          "last_comm_buffer_size_MB": 1,
                          "error_feedback": True,
                          "overlap": False,
                          "block_size": 1024},
    # telemetry (the reference's observability plane; read by no port code)
    "telemetry": False,
    "telemetry_configs": {"aggregate_every_n_steps": 0,
                          "http_port": 0,
                          "flight_recorder_capacity": 4096},
    "semi_auto": False,
    "auto_search": False,
    "heter_ccl_mode": False,
    "find_unused_parameters": False,
    "last_comm_group_size_MB": 1,
    "without_graph_optimization": False,
    # hybrid topology degrees (fleet_base.py:363)
    "hybrid_configs": {
        "dp_degree": -1,
        "mp_degree": 1,
        "pp_degree": 1,
        "sharding_degree": 1,
        "sep_degree": 1,
        "mp_configs": {},
        "pp_configs": {},
    },
}


# compatibility knobs with no behaviour here: setting one warns once
# instead of doing nothing silently
_INERT_BITS = {
    "semi_auto": "no auto-sharding planner is ported (ROADMAP Queue A "
                 "item 10, parallelism)",
    "auto_search": "no mesh search is ported (ROADMAP Queue A item 10, "
                   "parallelism)",
    "heter_ccl_mode": "heterogeneous collectives are not ported",
    "nccl_comm_num": "each rank issues its collectives on one process "
                     "group",
    "sync_nccl_allreduce": "every collective of the port is synchronous",
    "without_graph_optimization": "the port runs eagerly; there is no "
                                  "graph pass to bypass",
    "adaptive_localsgd": "loss-adaptive k is not implemented; "
                         "strategy.localsgd with localsgd_configs "
                         "k_steps gives fixed-interval LocalSGD",
}
_warned_inert: set = set()


class DistributedStrategy:
    def __init__(self):
        self._conf = copy.deepcopy(_DEFAULTS)

    def __getattr__(self, name):
        conf = object.__getattribute__(self, "_conf")
        if name in conf:
            return conf[name]
        raise AttributeError(f"DistributedStrategy has no field {name!r}")

    def __setattr__(self, name, value):
        if name == "_conf":
            object.__setattr__(self, name, value)
            return
        if name not in self._conf:
            raise ValueError(
                f"Unknown DistributedStrategy field {name!r} "
                f"(reference: distributed_strategy.proto)"
            )
        if name in _INERT_BITS and value != _DEFAULTS[name] \
                and name not in _warned_inert:
            _warned_inert.add(name)
            warnings.warn(f"DistributedStrategy.{name} is a compatibility "
                          f"no-op on this framework: {_INERT_BITS[name]}",
                          stacklevel=2)
        if name.endswith("_configs") and isinstance(self._conf[name], dict):
            # unknown sub-keys are refused (check_configs_key)
            cur = self._conf[name]
            for k in value:
                if k not in cur:
                    raise ValueError(f"Unknown key {k!r} for {name}")
            cur.update(value)
        else:
            self._conf[name] = value

    def to_dict(self):
        return copy.deepcopy(self._conf)

    def __repr__(self):
        on = [k for k, v in self._conf.items() if v is True]
        return f"DistributedStrategy(enabled={on})"
