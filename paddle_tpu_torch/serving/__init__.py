"""paddle_tpu_torch.serving — continuous-batching serving on the card
(reference: ``paddle_tpu/serving``).

  scheduler.py  admission-controlled request queue
  kv_cache.py   paged KV blocks on the device with int8/fp8 blockwise
                at-rest codecs (CUDA kernels), refcounted prefix sharing,
                copy-on-write, LRU, reserve/rollback
  model.py      GPT parameters -> prefill/decode/extend steps
  sampler.py    batched temperature/top-k/top-p sampling over
                per-request random streams (greedy = temperature 0)
  engine.py     the continuous-batching step loop with prefix-cached
                admission

Usage::

    model = GPTDecodeModel(GPTForCausalLM(gpt_presets("gpt-125m"), seed=0))
    pool = KVBlockPool(512, 16, model.elems_per_token, codec="int8_block")
    queue = RequestQueue()
    engine = ServingEngine(model, pool, queue, max_batch=8)
    queue.submit(ServeRequest(prompt_ids=np.arange(32), max_new_tokens=64))
    while engine.step():
        pass
"""
from .engine import ServingEngine
from .kv_cache import KV_CODECS, BlockTable, KVBlockPool, KVCacheOOM
from .model import GPTDecodeModel, bucket_pow2
from .sampler import BatchSampler, SamplingParams, default_sampler
from .scheduler import OUTCOMES, RequestQueue, ServeRequest

__all__ = [
    "ServingEngine", "KVBlockPool", "BlockTable", "KVCacheOOM", "KV_CODECS",
    "GPTDecodeModel", "bucket_pow2", "RequestQueue", "ServeRequest",
    "OUTCOMES", "BatchSampler", "SamplingParams", "default_sampler",
]
