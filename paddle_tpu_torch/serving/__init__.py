"""paddle_tpu_torch.serving — continuous-batching serving on the card
(reference: ``paddle_tpu/serving``).

  scheduler.py  admission-controlled request queue (drained requests
                re-admit at the head: zero lost), request traces
  kv_cache.py   paged KV blocks on the device with int8/fp8 blockwise
                at-rest codecs (CUDA kernels), refcounted prefix sharing,
                copy-on-write, LRU, reserve/rollback
  model.py      GPT parameters -> prefill/decode/extend steps;
                ``truncated(n)`` derives a draft model without a copy
  sampler.py    batched temperature/top-k/top-p sampling over
                per-request random streams (greedy = temperature 0)
  engine.py     the continuous-batching step loop with prefix-cached
                admission and lossless speculative decoding
  replica.py    N replicas behind the queue with watchdog and
                ReplicaGuard eviction, drain-and-re-admit, scaling and
                the warm handoff

Usage::

    model = GPTDecodeModel(GPTForCausalLM(gpt_presets("gpt-125m"), seed=0))
    rset = ReplicaSet(model, n_replicas=2, n_blocks=512,
                      codec="int8_block", max_batch=8,
                      draft_model=model.truncated(1), spec_k=4)
    with rset:
        rset.submit(ServeRequest(prompt_ids=np.arange(32),
                                 max_new_tokens=64, request_id="r0"))
        done = rset.wait(["r0"])
"""
from .engine import ReplicaBootBudgetExceeded, ServingEngine
from .kv_cache import KV_CODECS, BlockTable, KVBlockPool, KVCacheOOM
from .model import GPTDecodeModel, bucket_pow2
from .replica import ReplicaSet, StandbyReplica
from .sampler import BatchSampler, SamplingParams, default_sampler
from .scheduler import OUTCOMES, RequestQueue, ServeRequest

__all__ = [
    "ServingEngine", "ReplicaBootBudgetExceeded", "KVBlockPool",
    "BlockTable", "KVCacheOOM", "KV_CODECS", "GPTDecodeModel", "bucket_pow2",
    "ReplicaSet", "StandbyReplica", "RequestQueue", "ServeRequest",
    "OUTCOMES", "BatchSampler", "SamplingParams", "default_sampler",
]
