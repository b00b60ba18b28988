"""The LM's local update of every client's local steps (the f32 step
rounded to bf16), in ms a round.

Stream ms of an unprofiled round after the window: CUDA events around
every call of ``launch.fl_step._local_step``, summed. None where the
cell's program has no such call."""


def read(ctx):
    return ctx.spans_ms.get("local_update")
