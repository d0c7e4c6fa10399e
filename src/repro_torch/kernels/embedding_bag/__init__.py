from .kernel import (embedding_bag_cuda, embedding_lookup_cuda, geometry,
                     load_library)
from .ops import embedding_bag, embedding_lookup
from .ref import embedding_bag_ref

__all__ = ["embedding_bag", "embedding_bag_cuda", "embedding_bag_ref",
           "embedding_lookup", "embedding_lookup_cuda", "geometry",
           "load_library"]
