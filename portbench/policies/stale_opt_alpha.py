"""OPT-α solved on the first channel epoch and kept, projected onto each
later epoch's graph."""


def policy(spec: dict):
    from repro_torch import channels

    return channels.StaleOptAlpha(sweeps=spec["sweeps"])
