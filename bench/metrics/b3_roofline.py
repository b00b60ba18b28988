"""Kernel B3's share of its roofline, in %: ``csrc/bit_aggregate.cu``,
the vote count and the Eq.-13 estimate.

Its device time is the sum of its launches' records in the profiled
round (kernels whose name holds ``bit_aggregate_kernel``); its least time
the sum over the round's launches of the larger of bytes over the memory rate and
operations over the f32 rate, from ``work.b3_work`` at each launch's shape
and b at the length the round holds it (a scalar b counts 4 bytes, even
where the program widens it to a row before the launch).
None when the trace holds another number of launches than the round's
shapes (the kernel is off the path, or launched otherwise)."""

from bench import trace, work


def read(ctx):
    shapes = ctx.work["b3"]
    seconds, launches = trace.kernel_seconds(ctx.trace, "bit_aggregate_kernel")
    if not shapes or launches != len(shapes) or seconds <= 0:
        return None
    least = sum(work.least_seconds(*work.b3_work(m, d, b_len)) for m, d, b_len in shapes)
    return 100.0 * least / seconds
