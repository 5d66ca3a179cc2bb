from bsmr_sddmm.utils.check import check_values, CheckResult
from bsmr_sddmm.utils.timing import Timer, time_jax_fn
from bsmr_sddmm.utils.logger import RunLog

__all__ = ["check_values", "CheckResult", "Timer", "time_jax_fn", "RunLog"]
