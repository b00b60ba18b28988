"""The vision round's local training of the whole cohort (grouped
convolutions, autograd and the prox-SGD kernel B4), in ms a round.

Stream ms of an unprofiled round after the window: CUDA events around the
call of ``fl.rounds.local_prox_train``. None where the cell's program has
no such call."""


def read(ctx):
    return ctx.spans_ms.get("local_train")
