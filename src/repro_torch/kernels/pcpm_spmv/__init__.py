from .kernel import load_library, pcpm_gather_cuda
from .ops import PackedPNG, pack_blocked, pcpm_spmv_pallas
from .ref import pcpm_gather_ref

__all__ = ["load_library", "pcpm_gather_cuda", "PackedPNG", "pack_blocked",
           "pcpm_spmv_pallas", "pcpm_gather_ref"]
