"""The rounds' model FLOPs (``flops_per_round``: forward × 3, every
client's T·b samples) over the untraced window's seconds, as a share of the
H100's f32 rate outside the tensor cores (67 TFLOP/s)."""

from portbench.timing import PEAK_F32_FLOP_PER_S


def read(ctx):
    w = ctx.untraced_window
    if w is None or w.rounds == 0 or ctx.busy_s is None:
        return None
    return 100.0 * ctx.flops_per_round * w.rounds / w.seconds / PEAK_F32_FLOP_PER_S
