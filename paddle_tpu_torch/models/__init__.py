"""GPT, BERT and Wide&Deep models, and the weight converters, for the port
(reference: ``paddle_tpu/models``)."""
from .bert import (BertConfig, BertEmbeddings, BertForPretraining,
                   BertModel, BertPooler, BertPretrainingCriterion,
                   bert_presets)
from .convert import (bert_state_dict_from_numpy,
                      dense_state_dict_from_numpy, state_dict_from_numpy)
from .gpt import (BLOCK_PARAMS, GPTConfig, GPTDecoderLayer, GPTEmbeddings,
                  GPTForCausalLM, GPTModel, GPTPretrainingCriterion,
                  gpt_presets)
from .wide_deep import (WideDeep, WideDeepBench, ctr_batches,
                        wide_deep_loss, zipf_ids)

__all__ = ["BLOCK_PARAMS", "BertConfig", "BertEmbeddings",
           "BertForPretraining", "BertModel", "BertPooler",
           "BertPretrainingCriterion", "GPTConfig", "GPTDecoderLayer",
           "GPTEmbeddings", "GPTForCausalLM", "GPTModel",
           "GPTPretrainingCriterion", "bert_presets",
           "WideDeep", "WideDeepBench", "bert_state_dict_from_numpy",
           "ctr_batches", "dense_state_dict_from_numpy", "gpt_presets",
           "state_dict_from_numpy", "wide_deep_loss", "zipf_ids"]
