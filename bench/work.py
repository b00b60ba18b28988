"""The yardstick's arithmetic: published peaks of the card and the work of
each kernel and of a whole round, in closed form from shapes.

Peaks are NVIDIA's data sheet for one H100 SXM at its 700 W limit, dense
rates without sparsity. Byte counts read each input byte once and write
each output byte once, whatever a kernel reads again.
"""

from __future__ import annotations

PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}  # f32 outside the tensor cores (TF32 off)


def b3_work(m: int, d: int, b_len: int) -> tuple[int, int]:
    """(bytes, operations) of the count-and-estimate kernel B3 on ``m``
    clients' rows of ``d`` coordinates with a b of ``b_len`` values (1 for
    a scalar b, d for one a coordinate): the ceil(d / 8) wire bytes of each
    row, b read at its own length and theta written at length d; one vote
    add a coordinate a client and the estimate's 4 operations a
    coordinate."""
    return m * ((d + 7) // 8) + 4 * d + 4 * b_len, m * d + 4 * d


def b4_work(m: int, d: int) -> tuple[int, int]:
    """(bytes, operations) of the prox-SGD kernel B4 on an (m, d) cohort
    with one shared global row: w, grad and momentum read and w' and m'
    written once, w0 read once; 6 operations an element."""
    return 20 * m * d + 4 * d, 6 * m * d


def compress_bytes(m: int, d: int) -> int:
    """Least bytes of compressing ``m`` clients' f32 differences of ``d``
    coordinates onto the one-bit wire: each difference read once, each
    packed bit written once (the quantizer's uniforms are not counted: a
    draw inside the kernel reads none)."""
    return m * (4 * d + (d + 7) // 8)


def least_seconds(nbytes: float, ops: float = 0.0, flops_peak: float = PEAK_FLOPS["float32"]) -> float:
    """The least time the card could take: the larger of bytes over the
    memory rate and operations over the arithmetic rate."""
    return max(nbytes / PEAK_BYTES_PER_S, ops / flops_peak)


def decoder_matmul_params(cfg: dict) -> int:
    """Parameters of every matrix product of a dense GQA decoder with a
    SwiGLU FFN, the output head included (the embedding lookup is none; a
    head tied to the embedding is a product all the same)."""
    d, heads, kv = cfg["hidden_size"], cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd = d // heads
    per_layer = 2 * d * heads * hd + 2 * d * kv * hd + 3 * d * cfg["intermediate_size"]
    return cfg["num_hidden_layers"] * per_layer + d * cfg["vocab_size"]


def decoder_train_flops(cfg: dict, sequences: int, seq: int) -> float:
    """Model FLOPs of training on ``sequences`` of ``seq`` tokens:
    6 x matmul parameters x tokens, plus attention's scores and values
    (12 x layers x heads x head size x seq a token), nothing counted for
    recomputation."""
    tokens = sequences * seq
    d, heads = cfg["hidden_size"], cfg["num_attention_heads"]
    attn = 12 * cfg["num_hidden_layers"] * heads * (d // heads) * seq
    return 6.0 * decoder_matmul_params(cfg) * tokens + float(attn) * tokens


def resnet_forward_flops(cfg: dict) -> int:
    """Forward FLOPs of one image through the paper's ResNet: 2 x outputs x
    kernel area x input channels x output channels for each convolution
    (SAME padding, so an output side is ceil(side / stride)), and the dense
    head."""
    width, side, c = cfg["width"], cfg["image_size"], cfg["in_channels"]

    def conv(side_in, k, cin, cout, stride):
        out = -(-side_in // stride)
        return 2 * out * out * k * k * cin * cout, out

    total, _ = conv(side, 3, c, width, 1)
    ch = width
    for si, n in enumerate(cfg["blocks"]):
        out_ch = width * 2**si
        for bi in range(n):
            stride = 2 if (bi == 0 and si > 0) else 1
            f1, new_side = conv(side, 3, ch, out_ch, stride)
            f2, _ = conv(new_side, 3, out_ch, out_ch, 1)
            total += f1 + f2
            if stride != 1 or ch != out_ch:
                total += conv(side, 1, ch, out_ch, stride)[0]
            side, ch = new_side, out_ch
    return total + 2 * ch * cfg["classes"]
