"""The port's CUDA kernels and its train step on an NVIDIA GPU, with no
JAX import, so the file also runs on a machine that has only PyTorch:

    DPT_TESTS_ON_TPU=1 python -m pytest -m cuda tests/test_torch_cuda.py

(the variable keeps the root conftest from configuring JAX).  Every test
is marked ``cuda`` and skips without a card; chip_smoke.py runs the full
shape lists.  Tolerances: relative to the plain version's largest value,
1e-5 in f32 (the same f32 math in another order) and 2e-2 in bf16 (one
output rounding)."""

import numpy as np
import pytest
import torch

from distributedpytorch_tpu_torch.cli import kernel_launches
from distributedpytorch_tpu_torch.models import get_model
from distributedpytorch_tpu_torch.ops import flash_attention as tfa
from distributedpytorch_tpu_torch.ops.losses import cross_entropy
from distributedpytorch_tpu_torch.precision import PRESETS
from distributedpytorch_tpu_torch.train.engine import Engine

pytestmark = pytest.mark.cuda
TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_backward_kernels_match_plain_on_card(dtype):
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(0)
    dt = getattr(torch, dtype)
    for b, s, h, d, causal in ((64, 49, 4, 32, False), (2, 200, 2, 64, True),
                               (2, 1000, 2, 128, False)):
        qkv = torch.randn((b, s, 3 * h * d), generator=gen,
                          device="cuda").to(dt)
        q, k, v = (t.reshape(b, s, h, d) for t in qkv.split(h * d, dim=-1))
        do = torch.randn((b, s, h, d), generator=gen, device="cuda").to(dt)
        o, lse = tfa.flash_attention_fwd(q, k, v, causal)
        delta = tfa.attention_delta(o, do)
        n_dq, n_dkv = (tfa.flash_attention_dq.launches,
                       tfa.flash_attention_dkv.launches)
        dq = tfa.flash_attention_dq(q, k, v, do, lse, delta, causal)
        dk, dv = tfa.flash_attention_dkv(q, k, v, do, lse, delta, causal)
        torch.cuda.synchronize()
        assert tfa.flash_attention_dq.launches == n_dq + 1
        assert tfa.flash_attention_dkv.launches == n_dkv + 1
        want = tfa.flash_attention_bwd_plain(q, k, v, o, lse, do, causal)
        for got, ref in zip((dq, dk, dv), want):
            scale = ref.float().abs().max().item()
            assert (got.float() - ref.float()).abs().max().item() \
                <= TOL[dt] * scale


def test_backward_wrapper_raises_on_a_strided_head_dim():
    _need_card()
    q = torch.zeros((1, 49, 4, 32), device="cuda")
    lse = torch.zeros((4, 49), device="cuda")
    bad = torch.zeros((1, 49, 4, 64), device="cuda")[..., ::2]
    with pytest.raises(ValueError, match="head dim of dO contiguous"):
        tfa.flash_attention_dq(q, q, q, bad, lse, lse)


def test_empty_problem_launches_and_counts_nothing():
    """S = 0 returns empty gradients without a launch, and leaves every
    counter as it was."""
    _need_card()
    q = torch.zeros((1, 0, 4, 32), device="cuda")
    lse = torch.zeros((4, 0), device="cuda")
    counters = (tfa.flash_attention_fwd, tfa.flash_attention_dq,
                tfa.flash_attention_dkv)
    before = [c.launches for c in counters]
    o, _ = tfa.flash_attention_fwd(q, q, q)
    dq = tfa.flash_attention_dq(q, q, q, q, lse, lse)
    dk, dv = tfa.flash_attention_dkv(q, q, q, q, lse, lse)
    assert o.shape == dq.shape == dk.shape == dv.shape == (1, 0, 4, 32)
    assert [c.launches for c in counters] == before


def test_train_step_runs_each_kernel_once_per_block():
    """One bf16 train step of the full-width vit: 4 K1, 4 K2 and 4 K3
    launches, finite gradients on every parameter."""
    _need_card()
    policy = PRESETS["bf16"]
    model = get_model("vit", 10, policy, attention="flash", device="cuda")
    engine = Engine(model, cross_entropy, 0.13, 0.31, 28, policy, "cuda")
    state = engine.init_state(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    images = torch.from_numpy(rng.integers(0, 256, (64, 28, 28),
                                           dtype=np.uint8)).cuda()
    labels = torch.from_numpy(rng.integers(0, 10, 64)).cuda()
    before = kernel_launches()
    _, m = engine.train_step(state, images, labels,
                             torch.ones(64, dtype=torch.bool, device="cuda"),
                             torch.Generator(device="cuda").manual_seed(1))
    torch.cuda.synchronize()
    got = {k: v - before[k] for k, v in kernel_launches().items()}
    assert got == {"flash_fwd": 4, "flash_dq": 4, "flash_dkv": 4}
    assert torch.isfinite(m["loss"]).item()
    for name, p in model.named_parameters():
        assert p.grad is not None and torch.isfinite(p.grad).all(), name
