"""The yardstick's arithmetic against hand sums at toy shapes, the frozen
Threefry against known words and the program's generator, and the trace
reduction on made-up events."""

from __future__ import annotations

import pytest
import torch

from bench import trace, work
from bench.reference import threefry


def test_kernel_byte_and_operation_counts():
    assert work.b3_work(3, 17, 1) == (3 * 3 + 4 * 17 + 4, 3 * 17 + 4 * 17)  # a scalar b
    assert work.b3_work(3, 17, 17) == (3 * 3 + 8 * 17, 3 * 17 + 4 * 17)  # b a coordinate
    assert work.b4_work(3, 5) == (3 * 5 * 20 + 5 * 4, 6 * 3 * 5)
    assert work.compress_bytes(2, 9) == 2 * (9 * 4 + 2)
    assert work.least_seconds(3.35e12, 0.0) == pytest.approx(1.0)
    assert work.least_seconds(0.0, 67e12) == pytest.approx(1.0)


def test_decoder_flops_at_a_toy_shape():
    cfg = {"hidden_size": 8, "num_attention_heads": 2, "num_key_value_heads": 1, "intermediate_size": 12,
           "num_hidden_layers": 3, "vocab_size": 10}
    # per layer: q 8x8, k and v 8x4 each, o 8x8, three FFN matrices 8x12; head 8x10
    params = 3 * (64 + 32 + 32 + 64 + 3 * 96) + 80
    assert work.decoder_matmul_params(cfg) == params
    tokens = 2 * 5
    assert work.decoder_train_flops(cfg, 2, 5) == 6 * params * tokens + 12 * 3 * 2 * 4 * 5 * tokens


def test_resnet_flops_at_a_toy_shape():
    cfg = {"width": 2, "image_size": 8, "in_channels": 1, "blocks": [1, 1], "classes": 3}
    stem = 2 * 64 * 9 * 1 * 2
    s0 = 2 * (2 * 64 * 9 * 2 * 2)  # two 3x3 convolutions, 2 -> 2 channels at 8x8
    # stride 2 to 4x4 (2 -> 4 channels), then 4 -> 4, and the 1x1 projection
    s1 = 2 * 16 * 9 * 2 * 4 + 2 * 16 * 9 * 4 * 4 + 2 * 16 * 2 * 4
    assert work.resnet_forward_flops(cfg) == stem + s0 + s1 + 2 * 4 * 3


def test_frozen_threefry_known_words():
    # Random123's known-answer vectors of Threefry-2x32 with 20 rounds
    for key, ctr, out in (((0, 0), (0, 0), (0x6B200159, 0x99BA4EFE)),
                          ((0xFFFFFFFF, 0xFFFFFFFF), (0xFFFFFFFF, 0xFFFFFFFF), (0x1CB996FC, 0xBB002BE7)),
                          ((0x13198A2E, 0x03707344), (0x243F6A88, 0x85A308D3), (0xC4923A9C, 0x483DF7A0))):
        got = threefry.threefry2x32(*(torch.tensor([v], dtype=torch.int64) for v in key + ctr))
        assert (int(got[0]), int(got[1])) == out


def test_frozen_threefry_draws_the_programs_words():
    from repro_torch import prng
    from repro_torch.core.quantizer import client_uniforms

    seed = 2**31 + 12345
    k = threefry.key(seed)
    assert torch.equal(k, prng.key(seed))
    assert torch.equal(threefry.split(k, 3), prng.split(prng.key(seed), 3))
    ck = threefry.fold_in(k, 7)
    assert torch.equal(threefry.chunk_uniforms(ck, 20_000), client_uniforms(ck, 20_000))
    assert torch.equal(threefry.randint(ck, 24, 100), prng.randint(ck, (24,), 0, 100))


class _Event:
    def __init__(self, name, device, start, end, stream=0):
        self._n, self._d, self._s, self._e, self._r = name, device, start, end, stream

    def name(self):
        return self._n

    def device_type(self):
        return self._d

    def start_ns(self):
        return self._s

    def end_ns(self):
        return self._e

    def device_resource_id(self):
        return self._r

    def is_user_annotation(self):
        return False


def test_reduce_events_unions_streams_and_labels_gaps():
    from torch.autograd import DeviceType

    cpu, gpu = DeviceType.CPU, DeviceType.CUDA
    events = [_Event(trace.ROUND_RANGE, cpu, 0, 100), _Event("aten::item", cpu, 60, 90),
              _Event("k1", gpu, 10, 40, 7), _Event("k2", gpu, 30, 50, 8), _Event("k1", gpu, 95, 120, 7),
              _Event("round.compress", gpu, 10, 50), _Event("Buffer Flush", gpu, 50, 60)]
    rt = trace.reduce_events(events)
    assert rt.window_s == pytest.approx(100e-9) and rt.busy_s == pytest.approx(45e-9)  # [10, 50) and [95, 100)
    assert rt.by_name == {"k1": pytest.approx(55e-9), "k2": pytest.approx(20e-9)}
    assert rt.idle_gaps[0] == ["host: aten::item", pytest.approx(45e-9)]
    assert trace.kernel_seconds(rt, "k1") == (pytest.approx(55e-9), 2)


def test_reduce_events_of_the_card_alone_take_the_hosts_length():
    from torch.autograd import DeviceType

    gpu = DeviceType.CUDA
    events = [_Event("k1", gpu, 10, 40, 7), _Event("k2", gpu, 30, 50, 8), _Event("k1", gpu, 95, 120, 7)]
    rt = trace.reduce_events(events, window_s=150e-9)
    assert rt.window_s == 150e-9 and rt.busy_s == pytest.approx(65e-9)  # [10, 50) and [95, 120)
    with pytest.raises(RuntimeError):
        trace.reduce_events(events)
