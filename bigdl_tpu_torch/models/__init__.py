from bigdl_tpu_torch.models.gpt import (GPT, GPTForCausalLM,
                                        TransformerDecoderBlock, gpt2_small,
                                        gpt_flops_per_token, prompt_bucket,
                                        sample_logits)

__all__ = ["GPT", "GPTForCausalLM", "TransformerDecoderBlock", "gpt2_small",
           "gpt_flops_per_token", "prompt_bucket", "sample_logits"]
