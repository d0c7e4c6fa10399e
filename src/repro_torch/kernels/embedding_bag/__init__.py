from .kernel import (embedding_bag_bwd_cuda, embedding_bag_cuda,
                     embedding_lookup_cuda, geometry, load_library)
from .ops import (EmbeddingBag, SegmentSum, embedding_bag, embedding_lookup,
                  segment_sum)
from .ref import (embedding_bag_bwd_emulate, embedding_bag_bwd_ref,
                  embedding_bag_ref, sorted_keys)

__all__ = ["EmbeddingBag", "embedding_bag", "embedding_bag_bwd_cuda",
           "embedding_bag_bwd_emulate", "embedding_bag_bwd_ref",
           "embedding_bag_cuda", "embedding_bag_ref", "embedding_lookup",
           "embedding_lookup_cuda", "geometry", "load_library",
           "segment_sum", "SegmentSum", "sorted_keys"]
