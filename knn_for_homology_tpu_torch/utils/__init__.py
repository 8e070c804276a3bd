from .logging import configure_logging, TqdmLoggingHandler
from .timing import Timer, write_time_sidecar

__all__ = [
    "configure_logging",
    "TqdmLoggingHandler",
    "Timer",
    "write_time_sidecar",
]
