"""Models (counterpart: ``paddle_tpu/models``): the ported families under
the reference's names."""
from .bert import (BertConfig, BertForPretraining, BertModel,  # noqa: F401
                   bert_base, bert_large, synthetic_mlm_batch)
from .gpt import (GPTConfig, GPTForCausalLM, GPTModel,  # noqa: F401
                  build_gpt_1f1b_step, build_pipeline_layer, gpt3_1p3b,
                  gpt_small, synthetic_lm_batch)

__all__ = ["BertConfig", "BertModel", "BertForPretraining", "bert_base",
           "bert_large", "synthetic_mlm_batch", "GPTConfig", "GPTModel",
           "GPTForCausalLM", "gpt_small", "gpt3_1p3b", "build_pipeline_layer",
           "build_gpt_1f1b_step", "synthetic_lm_batch"]
