from .llama import LlamaConfig, LlamaForCausalLM
from .trainer import build_train_step, prefetch_batches

__all__ = ["LlamaConfig", "LlamaForCausalLM", "build_train_step",
           "prefetch_batches"]
