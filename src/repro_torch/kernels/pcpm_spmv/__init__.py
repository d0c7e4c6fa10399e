from .kernel import (b1_path, load_library, pcpm_gather_cuda, pcpm_spmv_cuda,
                     tile_gather_cuda)
from .ops import (PackedPNG, TileSchedule, pack_blocked, pcpm_spmv_pallas,
                  pcpm_spmv_tile, tile_schedule)
from .ref import pcpm_gather_ref, pcpm_spmv_ref, tile_gather_ref

__all__ = ["b1_path", "load_library", "pcpm_gather_cuda", "pcpm_spmv_cuda",
           "tile_gather_cuda", "PackedPNG", "TileSchedule", "pack_blocked",
           "pcpm_spmv_pallas", "pcpm_spmv_tile", "tile_schedule",
           "pcpm_gather_ref", "pcpm_spmv_ref", "tile_gather_ref"]
