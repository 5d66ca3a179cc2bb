from bsmr_sddmm.models.block_sparse_attention import (BlockSparseAttention,
                                                     make_attention_mask)
from bsmr_sddmm.models.factorization import SparseFactorizationModel
from bsmr_sddmm.models.graph_attention import GraphAttentionLayer

__all__ = ["SparseFactorizationModel", "GraphAttentionLayer",
           "BlockSparseAttention", "make_attention_mask"]
