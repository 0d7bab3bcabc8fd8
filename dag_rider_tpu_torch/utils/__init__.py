"""Metrics, structured events, checkpoints, the native challenge library and
the nvcc build of ``csrc/``."""

from dag_rider_tpu_torch.utils.metrics import Metrics, Timer
from dag_rider_tpu_torch.utils.slog import NOOP, EventLog, capture, stdlib_sink

__all__ = ["Metrics", "Timer", "NOOP", "EventLog", "capture", "stdlib_sink"]
