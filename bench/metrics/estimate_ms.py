"""The wire's server half in ms a round: the Eq.-13 estimate from the
clients' rows (the count kernel B3).

Stream ms of an unprofiled round after the window: CUDA events around
every call of ``AggregatorPipeline.estimate`` (the LM round: one a leaf;
the vision round: one), summed."""


def read(ctx):
    return ctx.spans_ms.get("estimate")
