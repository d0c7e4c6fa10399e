from .kernel import (flash_attention_bwd_cuda, flash_attention_cuda,
                     kv_tile_range, load_library)
from .ops import FlashAttention, attention
from .ref import attention_bwd_ref, attention_ref, lse_ref, mha_ref

__all__ = ["FlashAttention", "attention", "attention_bwd_ref",
           "attention_ref", "flash_attention_bwd_cuda",
           "flash_attention_cuda", "kv_tile_range", "load_library",
           "lse_ref", "mha_ref"]
