from .gpt import GPTConfig, GPTForCausalLM
from .llama import LlamaConfig, LlamaForCausalLM
from .trainer import build_train_step, prefetch_batches

__all__ = ["GPTConfig", "GPTForCausalLM", "LlamaConfig", "LlamaForCausalLM",
           "build_train_step", "prefetch_batches"]
