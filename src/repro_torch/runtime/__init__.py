"""The port's runtime (counterpart of ``repro.runtime``): async
checkpoints and restart on failure."""
from .checkpoint import AsyncCheckpointer, latest_step, restore, save_sync
from .fault import FaultTolerantRunner, Heartbeat

__all__ = ["AsyncCheckpointer", "save_sync", "restore", "latest_step",
           "FaultTolerantRunner", "Heartbeat"]
