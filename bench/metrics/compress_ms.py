"""The wire's client half in ms a round: compressing every client's model
difference onto the one-bit wire (the Threefry uniforms and the pack
kernel B1).

Stream ms of an unprofiled round after the window: CUDA events around
every call of ``ClientCompressor.compress`` (the LM round: one a client
and leaf) or ``AggregatorPipeline.compress_wire`` (the vision round: one
for the cohort), summed."""


def read(ctx):
    return ctx.spans_ms.get("compress")
