"""The LM's forward and backward passes of every client's local steps, in
ms a round.

Stream ms of an unprofiled round after the window: CUDA events around
every call of ``launch.fl_step._value_and_grad``, summed. None where the
cell's program has no such call."""


def read(ctx):
    return ctx.spans_ms.get("forward_backward")
