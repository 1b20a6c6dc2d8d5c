"""The streaming decoder's host copies on the card.

``streaming.copy_to_host_async`` copies into pinned memory without
blocking and records an event; a reader waits on that event.  Checked: the
copy holds the tensor's values at the time it was enqueued, although the
source is overwritten later on the same stream and the reader comes after
that; deferred windows (``AsyncDeviceWindows``: read one push later,
speculated windows sliced on the host) are byte-equal to the inline ones
of ``DeviceStreamingDecoder`` through the pacer, with and without the
int16 wire.

Needs a CUDA device (skips without one); imports no JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_stream_gpu.py
"""

import numpy as np
import pytest
import torch

from chattts_tpu_torch import Chat
from chattts_tpu_torch.config import (Config, ConvStackConfig, DecoderConfig,
                                      GPTConfig, VocosConfig)
from chattts_tpu_torch.engine import streaming

pytestmark = pytest.mark.gpu


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def test_host_copy_holds_the_values_it_was_given(cuda):
    src = torch.arange(1 << 20, dtype=torch.float32, device=cuda)
    want = src.cpu().numpy()
    copy = streaming.copy_to_host_async(src)
    src.mul_(-1.0)  # enqueued after the copy on the same stream
    for _ in range(20):  # keep the stream busy past the read
        src.add_(1.0)
    got = np.asarray(copy)
    assert copy.ready()
    np.testing.assert_array_equal(got, want)


@pytest.fixture()
def small_chat(cuda):
    cfg = Config(
        gpt=GPTConfig(hidden_size=128, intermediate_size=256,
                      num_attention_heads=2, num_hidden_layers=2,
                      max_position_embeddings=512),
        decoder=DecoderConfig(stack=ConvStackConfig(
            idim=64, odim=96, hidden=128, n_layer=4)),
        vocos=VocosConfig(dim=128, intermediate_dim=256, num_layers=2))
    chat = Chat(config=cfg)
    chat.load(source="random", seed=0)
    return chat


@pytest.mark.parametrize("wire", [False, True])
def test_deferred_windows_are_byte_equal_to_inline(small_chat, wire):
    chat = small_chat
    chat.config = chat.config.with_runtime(wire_int16=wire)
    B, T, D = 3, 120, chat.config.gpt.hidden_size
    g = torch.Generator().manual_seed(1)
    full = torch.randn((B, T + 40, D), generator=g).cuda()
    end = torch.tensor([T, 97, 64], device="cuda")
    deferred = chat._device_stream_decoder(B, 24, async_windows=True)
    inline = chat._device_stream_decoder(B, 24, async_windows=False)
    pa = streaming.EmissionPacer(B, 1, 8000, wire)
    pb = streaming.EmissionPacer(B, 1, 8000, wire)
    outs_a, outs_b = [], []
    for n in range(24, T + 1, 24):
        final = n == T
        if not final:
            deferred.speculate_window(full, n, end)
        a = pa.push(deferred.update_dev(full[:, :n], n, final=final,
                                        end_dev=end), final=final)
        b = pb.push(inline.update_dev(full[:, :n], n, final=final,
                                      end_dev=end), final=final)
        outs_a += [] if a is None else [a]
        outs_b += [] if b is None else [b]
    outs_a.append(pa.flush())
    outs_b.append(pb.flush())
    a, b = np.concatenate(outs_a, axis=1), np.concatenate(outs_b, axis=1)
    assert a.shape == b.shape and a.shape[1] > 0
    assert a.tobytes() == b.tobytes()
