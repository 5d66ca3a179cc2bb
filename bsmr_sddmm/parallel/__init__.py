from bsmr_sddmm.parallel.mesh import make_mesh
from bsmr_sddmm.parallel.dist import DistributedHybridSDDMM

__all__ = ["make_mesh", "DistributedHybridSDDMM"]
