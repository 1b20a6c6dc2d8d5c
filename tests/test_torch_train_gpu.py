"""The training step on the card against the CPU, and a checkpoint restored
on the card.

The full width cut to 2 layers, B 2, T 128: three steps from one state
and batch on each device, as ``chip_smoke.py``'s ``phase_train`` holds
them, with its limits, each set between the sound run's reading and those
of faults planted in the card's run (PERF.md section 6).  cuBLAS and the
CPU sum bf16 products in another order, so an activation may round one
bf16 ulp the other way, and a gradient element near zero may then take
Adam's step (about lr) the other way: each loss within 5e-4 of its value
a step taken, a leaf's mean gap within 5e-4, and at most 1e-2 of all
parameter elements more than the peak learning rate apart.  The restored
state's next step equals the original's bit for bit.

Needs a CUDA device (skips without one); imports no JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_train_gpu.py
"""

import dataclasses

import pytest
import torch

from chattts_tpu_torch import train
from chattts_tpu_torch.config import GPTConfig
from chattts_tpu_torch.utils import checkpoint
from chattts_tpu_torch.weights import to_device

pytestmark = pytest.mark.gpu

LAYERS, B, T, STEPS = 2, 2, 128, 3


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _setup(device):
    cfg = dataclasses.replace(GPTConfig(), num_hidden_layers=LAYERS)
    opt = train.make_optimizer(lr=3e-3, warmup=1)
    state = train.init_train_state(torch.Generator().manual_seed(0), cfg,
                                   opt, device=device)
    batch = train.random_batch(torch.Generator().manual_seed(1), cfg, B, T,
                               device=device)
    return cfg, opt, state, batch, train.make_train_step(cfg, opt)


def _run(state, batch, step):
    losses = []
    for _ in range(STEPS):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    return state, losses


def test_card_steps_match_cpu_at_two_layers(cuda):
    _, opt, s_cpu, b_cpu, step = _setup("cpu")
    s_dev, l_dev = _run(to_device(s_cpu, cuda), to_device(b_cpu, cuda), step)
    s_cpu, l_cpu = _run(s_cpu, b_cpu, step)
    for i, (a, b) in enumerate(zip(l_dev, l_cpu)):
        assert abs(a - b) <= 5e-4 * (1 + i) * abs(b), (i, a, b)
    assert l_dev[0] == pytest.approx(l_dev[1], abs=0)  # lr 0 at count 0
    lr = max(float(opt.schedule(torch.tensor(i, dtype=torch.int32)))
             for i in range(STEPS))
    over = n = 0
    for a, b in zip(train.tree_leaves((s_dev.gpt, s_dev.embed)),
                    train.tree_leaves((s_cpu.gpt, s_cpu.embed))):
        assert a.device.type == "cuda" and a.dtype == b.dtype
        d = (a.cpu().float() - b.float()).abs()
        assert float(d.mean()) <= 5e-4
        over, n = over + int((d > lr).sum()), n + d.numel()
    assert over / n <= 1e-2, over / n


def test_checkpoint_on_card_continues_bit_for_bit(cuda, tmp_path):
    cfg, opt, state, batch, step = _setup(cuda)
    state, _ = _run(state, batch, step)
    path = checkpoint.save_train_state(str(tmp_path), state)
    template = train.init_train_state(torch.Generator().manual_seed(7), cfg,
                                      opt, device=cuda)
    restored = checkpoint.restore_train_state(path, template)
    a, m_a = step(state, batch)
    b, m_b = step(restored, batch)
    assert torch.equal(m_a["loss"], m_b["loss"])
    for x, y in zip(train.tree_leaves(a), train.tree_leaves(b)):
        assert x.device == y.device and x.dtype == y.dtype
        assert torch.equal(x, y)
