"""Single-host FL simulator and its round engines."""
from repro_torch.fl.async_engine import AsyncRoundEngine
from repro_torch.fl.engine import EpochScanEngine, PipelinedScanEngine, run_rounds_loop
from repro_torch.fl.simulator import FLSimulator

__all__ = [
    "AsyncRoundEngine",
    "EpochScanEngine",
    "FLSimulator",
    "PipelinedScanEngine",
    "run_rounds_loop",
]
