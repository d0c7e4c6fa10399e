from . import pcpm_spmv

__all__ = ["pcpm_spmv"]
