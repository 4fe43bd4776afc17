"""Models (counterpart: ``paddle_tpu/models``): the ported families under
the reference's names."""
from .bert import (BertConfig, BertForPretraining, BertModel,  # noqa: F401
                   bert_base, bert_large, synthetic_mlm_batch)
from .gpt import (GPTConfig, GPTForCausalLM, GPTModel,  # noqa: F401
                  gpt_small, synthetic_lm_batch)

__all__ = ["BertConfig", "BertModel", "BertForPretraining", "bert_base",
           "bert_large", "synthetic_mlm_batch", "GPTConfig", "GPTModel",
           "GPTForCausalLM", "gpt_small", "synthetic_lm_batch"]
