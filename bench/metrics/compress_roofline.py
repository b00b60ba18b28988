"""The compress step's share of its least time, in %.

The least time is the least bytes of the work, from shapes, over the
card's memory rate: each client's f32 model difference read once and its
packed bits written once (the Threefry uniforms are not counted, so the
count holds when the draw moves inside the kernel). The time is
``compress_ms``."""

from bench import work


def read(ctx):
    ms = ctx.spans_ms.get("compress")
    if not ms:
        return None
    least = sum(work.compress_bytes(m, d) for m, d in ctx.work["compress"]) / work.PEAK_BYTES_PER_S
    return 100.0 * least / (ms / 1e3)
