from .kernel import flash_attention_cuda, kv_tile_range, load_library
from .ops import attention
from .ref import attention_ref, mha_ref

__all__ = ["attention", "attention_ref", "flash_attention_cuda",
           "kv_tile_range", "load_library", "mha_ref"]
