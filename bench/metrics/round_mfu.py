"""The whole round's share of the card's peak, in %: the model FLOPs of a
round from the configuration's shapes (``work.decoder_train_flops``,
``work.resnet_forward_flops``; nothing counted for recomputation) over the
window's seconds a round times the peak of the configuration's precision
(``work.PEAK_FLOPS``)."""


def read(ctx):
    return 100.0 * ctx.work["model_flops"] / (ctx.round_s * ctx.work["peak_flops"])
