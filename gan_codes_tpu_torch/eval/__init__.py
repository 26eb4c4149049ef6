"""IS/FID evaluation of the port (`eval/metrics.py`)."""
from .metrics import (compute_fid, compute_inception_score,  # noqa: F401
                      compute_is_fid, sqrtm_trace_newton_schulz)
