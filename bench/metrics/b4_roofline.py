"""Kernel B4's share of its roofline, in %: ``csrc/prox_sgd.cu``, the
fused prox-SGD step.

Its device time is the sum of its launches' records in the profiled
round (kernels whose name holds ``prox_sgd_kernel``); its least time the
sum over the round's launches of the larger of bytes over the memory rate and
operations over the f32 rate, from ``work.b4_work`` at each launch's shape.
None when the trace holds another number of launches than the round's
shapes (the kernel is off the path, or launched otherwise)."""

from bench import trace, work


def read(ctx):
    shapes = ctx.work["b4"]
    seconds, launches = trace.kernel_seconds(ctx.trace, "prox_sgd_kernel")
    if not shapes or launches != len(shapes) or seconds <= 0:
        return None
    least = sum(work.least_seconds(*work.b4_work(m, d)) for m, d in shapes)
    return 100.0 * least / seconds
