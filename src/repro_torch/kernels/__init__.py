from . import _build, embedding_bag, flash_attention, pcpm_spmv

__all__ = ["build_all", "embedding_bag", "flash_attention", "pcpm_spmv"]


def build_all() -> list[_build.Built]:
    """Build every kernel of the port, one ``nvcc`` each, all started
    together (each kernel's ``load_library`` then finds its library)."""
    return _build.build(pcpm_spmv.kernel.SOURCE, flash_attention.kernel.SOURCE,
                        flash_attention.kernel.BWD_SOURCE,
                        embedding_bag.kernel.SOURCE)
