"""GPT model for the port (reference: ``paddle_tpu/models``)."""
from .convert import state_dict_from_numpy
from .gpt import (BLOCK_PARAMS, GPTConfig, GPTDecoderLayer, GPTEmbeddings,
                  GPTForCausalLM, GPTModel, GPTPretrainingCriterion,
                  gpt_presets)

__all__ = ["BLOCK_PARAMS", "GPTConfig", "GPTDecoderLayer", "GPTEmbeddings",
           "GPTForCausalLM", "GPTModel", "GPTPretrainingCriterion",
           "gpt_presets", "state_dict_from_numpy"]
