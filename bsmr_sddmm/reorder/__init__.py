from bsmr_sddmm.reorder.rows import row_reordering, RowReorderResult
from bsmr_sddmm.reorder.cols import col_reordering, ColReorderResult
from bsmr_sddmm.reorder.bsmr import BSMR
from bsmr_sddmm.reorder.pack import PackedMatrix, pack

__all__ = [
    "row_reordering",
    "RowReorderResult",
    "col_reordering",
    "ColReorderResult",
    "BSMR",
    "PackedMatrix",
    "pack",
]
