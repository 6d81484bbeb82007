"""The port's ``PipelinedScanEngine``: chunks of ``chunk`` rounds captured
as CUDA graphs and replayed, host staging on a worker thread (the
engine's ``prefetch="thread"``)."""


def engine(spec: dict, sim):
    from repro_torch.fl.engine import PipelinedScanEngine

    return PipelinedScanEngine(sim, chunk=spec["chunk"], prefetch="thread")
