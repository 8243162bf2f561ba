"""GPT and BERT models, and the ResNet converter, for the port (reference: ``paddle_tpu/models``)."""
from .bert import (BertConfig, BertEmbeddings, BertForPretraining,
                   BertModel, BertPooler, BertPretrainingCriterion,
                   bert_presets)
from .convert import (bert_state_dict_from_numpy,
                      resnet_state_dict_from_numpy, state_dict_from_numpy)
from .gpt import (BLOCK_PARAMS, GPTConfig, GPTDecoderLayer, GPTEmbeddings,
                  GPTForCausalLM, GPTModel, GPTPretrainingCriterion,
                  gpt_presets)

__all__ = ["BLOCK_PARAMS", "BertConfig", "BertEmbeddings",
           "BertForPretraining", "BertModel", "BertPooler",
           "BertPretrainingCriterion", "GPTConfig", "GPTDecoderLayer",
           "GPTEmbeddings", "GPTForCausalLM", "GPTModel",
           "GPTPretrainingCriterion", "bert_presets",
           "bert_state_dict_from_numpy", "gpt_presets",
           "resnet_state_dict_from_numpy", "state_dict_from_numpy"]
