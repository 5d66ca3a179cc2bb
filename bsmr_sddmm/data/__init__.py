from bsmr_sddmm.data.sparse import CSR, COO
from bsmr_sddmm.data import io as io
from bsmr_sddmm.data import generate as generate

__all__ = ["CSR", "COO", "io", "generate"]
