"""The port's CUDA kernels and its train steps on an NVIDIA GPU, with no
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
        n_dq, n_dkv = (tfa.flash_attention_dq.launches,
                       tfa.flash_attention_dkv.launches)
        dq, delta = tfa.flash_attention_dq(q, k, v, o, do, lse, causal)
        dk, dv = tfa.flash_attention_dkv(q, k, v, do, lse, delta, causal)
        torch.cuda.synchronize()
        assert tfa.flash_attention_dq.launches == n_dq + 1
        assert tfa.flash_attention_dkv.launches == n_dkv + 1
        want_delta = tfa.attention_delta(o, do)
        assert (delta - want_delta).abs().max().item() \
            <= 1e-5 * want_delta.abs().max().item()
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
        tfa.flash_attention_dq(q, q, q, q, bad, lse)


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
    dq, delta = tfa.flash_attention_dq(q, q, q, q, q, lse)
    dk, dv = tfa.flash_attention_dkv(q, q, q, q, lse, lse)
    assert o.shape == dq.shape == dk.shape == dv.shape == (1, 0, 4, 32)
    assert delta.shape == (4, 0)
    assert [c.launches for c in counters] == before


def test_backward_tensor_core_route_matches_plain_on_card():
    """bf16 K2 and K3 on the tensor cores at the vit's shape and at a
    causal, ragged S = 200 with D = 64: the rule picks them, the counters
    say so, both routes (the scalar one forced) agree with the plain
    version, two calls are bit-identical, and K2's delta is
    ``attention_delta`` within 1e-5 of its largest value."""
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(2)
    dt = torch.bfloat16
    for b, s, h, d, causal in ((64, 49, 4, 32, False), (2, 200, 2, 64, True)):
        qkv = torch.randn((b, s, 3 * h * d), generator=gen,
                          device="cuda").to(dt)
        q, k, v = (t.reshape(b, s, h, d) for t in qkv.split(h * d, dim=-1))
        do = torch.randn((b, s, h, d), generator=gen, device="cuda").to(dt)
        o, lse = tfa.flash_attention_fwd(q, k, v, causal)
        assert tfa._pick_route(None, (q, k, v, do, o))
        before = [(w.launches, w.tensor_core_launches)
                  for w in (tfa.flash_attention_dq, tfa.flash_attention_dkv)]
        dq, delta = tfa.flash_attention_dq(q, k, v, o, do, lse, causal)
        dk, dv = tfa.flash_attention_dkv(q, k, v, do, lse, delta, causal)
        again = tfa.flash_attention_bwd(q, k, v, o, lse, do, causal)
        torch.cuda.synchronize()
        after = [(w.launches, w.tensor_core_launches)
                 for w in (tfa.flash_attention_dq, tfa.flash_attention_dkv)]
        assert after == [(n + 2, c + 2) for n, c in before]
        for got, rep in zip((dq, dk, dv), again):
            assert torch.equal(got, rep)
        want_delta = tfa.attention_delta(o, do)
        assert (delta - want_delta).abs().max().item() \
            <= 1e-5 * want_delta.abs().max().item()
        sdq, sdelta = tfa._dq_launch(q, k, v, o, do, lse, causal,
                                     tensor_core=False)
        sdk, sdv = tfa._dkv_launch(q, k, v, do, lse, sdelta, causal,
                                   tensor_core=False)
        torch.cuda.synchronize()
        want = tfa.flash_attention_bwd_plain(q, k, v, o, lse, do, causal)
        for got, scalar, ref in zip((dq, dk, dv), (sdq, sdk, sdv), want):
            scale = ref.float().abs().max().item()
            for x in (got, scalar):
                assert (x.float() - ref.float()).abs().max().item() \
                    <= TOL[dt] * scale


def test_partial_backward_tensor_core_route_matches_plain_on_card():
    """bf16 K2p and K3p on the tensor cores at the vit's ring shard (rank
    1's queries against rank 0's keys, kv_valid 49) and at a causal future
    block (every key masked) with a random dO and dlse: the rule picks
    them, the counters say so, K2p's bf16 dO is torch's rounding, both
    routes (the scalar one forced) agree with the plain version, dv of the
    all-masked rows is the sum of dO, two calls are bit-identical, and
    K2p's delta is ``partial_delta`` within 1e-5 of its largest value."""
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(3)
    dt = torch.bfloat16
    counters = (tfa.flash_attention_partial_dq,
                tfa.flash_attention_partial_dkv)

    def close(x, ref, tol):
        scale = ref.float().abs().max().item()
        return (x.float() - ref.float()).abs().max().item() <= tol * scale

    for b, s, h, d, causal, qb, kb, kv_valid in (
            (128, 25, 4, 32, False, 1, 0, 49),
            (8, 128, 4, 64, True, 0, 1, None)):
        qkv = torch.randn((b, s, 3 * h * d), generator=gen,
                          device="cuda").to(dt)
        q, k, v = (t.reshape(b, s, h, d) for t in qkv.split(h * d, dim=-1))
        base = torch.arange(s, dtype=torch.int32, device="cuda")
        qp, kp = base + qb * s, base + kb * s
        do = torch.randn((b, s, h, d), generator=gen, device="cuda")
        dlse = torch.randn((b * h, s), generator=gen, device="cuda")
        o, lse = tfa.flash_attention_partial_fwd(q, k, v, qp, kp, causal,
                                                 kv_valid)
        assert tfa._pick_route(None, (q, k, v, do, o), positional=True)
        before = [(w.launches, w.tensor_core_launches) for w in counters]
        dq, delta, do16 = tfa.flash_attention_partial_dq(
            q, k, v, o, do, lse, dlse, qp, kp, causal, kv_valid)
        dk, dv = tfa.flash_attention_partial_dkv(q, k, v, do16, lse, delta,
                                                 qp, kp, causal, kv_valid)
        again = tfa.flash_attention_partial_bwd(q, k, v, o, lse, do, dlse,
                                                qp, kp, causal, kv_valid)
        torch.cuda.synchronize()
        after = [(w.launches, w.tensor_core_launches) for w in counters]
        assert after == [(n + 2, c + 2) for n, c in before]
        assert torch.equal(do16, do.to(dt))
        for got, rep in zip((dq, dk, dv), again):
            assert torch.equal(got, rep)
        want_delta = tfa.partial_delta(o, do, dlse)
        sdq, sdelta, sdo = tfa._dq_pos_launch(q, k, v, o, do, lse, dlse, qp,
                                              kp, causal, kv_valid,
                                              tensor_core=False)
        assert sdo is do
        sdk, sdv = tfa.flash_attention_partial_dkv(q, k, v, sdo, lse, sdelta,
                                                   qp, kp, causal, kv_valid)
        torch.cuda.synchronize()
        for x in (delta, sdelta):
            assert close(x, want_delta, 1e-5)
        want = tfa.flash_attention_partial_bwd_plain(
            q, k, v, o, lse, do, dlse, qp, kp, causal, kv_valid)
        for got, scalar, ref in zip((dq, dk, dv), (sdq, sdk, sdv), want):
            assert close(got, ref, TOL[dt]) and close(scalar, ref, TOL[dt])
        if causal:
            # every key masked: p = exp(-1e30 - lse) = 1 in every row
            assert (lse == -1e30).all() and not dq.any() and not dk.any()
            sum_do = do.sum(dim=1, keepdim=True).expand(-1, s, -1, -1)
            assert close(dv, sum_do, TOL[dt])


def test_forward_tensor_core_route_matches_plain_on_card():
    """bf16 K1 and K4 on the tensor cores: K1 at the vit's shape and at a
    causal, ragged S = 200 with D = 64, K4 at the vit's ring shard (rank 1's
    queries against rank 0's keys, kv_valid 49) and at a causal future
    block (every key masked).  The rule picks the tensor cores, the
    counters say so, two calls are bit-identical, and both routes (the
    scalar one forced) agree with the plain version: O within 2e-2 (K4's
    scalar route, whose p stays f32: 2e-5) and lse within 1e-4; a row with
    no key gives O = 0 and lse = -1e30."""
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(4)
    dt = torch.bfloat16
    cases = ((64, 49, 4, 32, False, None), (2, 200, 2, 64, True, None),
             (128, 25, 4, 32, False, (1, 0, 49)),
             (8, 128, 4, 64, True, (0, 1, None)))
    for b, s, h, d, causal, ring in cases:
        qkv = torch.randn((b, s, 3 * h * d), generator=gen,
                          device="cuda").to(dt)
        q, k, v = (t.reshape(b, s, h, d) for t in qkv.split(h * d, dim=-1))
        if ring is None:
            wrapper, pos = tfa.flash_attention_fwd, None
            call = (lambda: tfa.flash_attention_fwd(q, k, v, causal))
            plain = tfa.flash_attention_plain(q, k, v, causal)
        else:
            base = torch.arange(s, dtype=torch.int32, device="cuda")
            pos = (base + ring[0] * s, base + ring[1] * s, ring[2])
            wrapper = tfa.flash_attention_partial_fwd
            call = (lambda: tfa.flash_attention_partial_fwd(
                q, k, v, pos[0], pos[1], causal, pos[2]))
            plain = tfa.flash_attention_partial_plain(q, k, v, *pos[:2],
                                                      causal, pos[2])
        assert tfa._pick_route(None, (q, k, v))
        before = (wrapper.launches, wrapper.tensor_core_launches)
        (o, lse), again = call(), call()
        scalar = tfa._launch(q, k, v, causal, pos, wrapper,
                             tensor_core=False)
        torch.cuda.synchronize()
        assert (wrapper.launches, wrapper.tensor_core_launches) == (
            before[0] + 3, before[1] + 2)
        assert torch.equal(o, again[0]) and torch.equal(lse, again[1])
        for (x_o, x_lse), tol in (((o, lse), 2e-2),
                                  (scalar, 2e-2 if ring is None else 2e-5)):
            assert (x_o.float() - plain[0].float()).abs().max().item() <= tol
            assert (x_lse - plain[1]).abs().max().item() <= 1e-4
        if ring is not None and causal:
            # every key masked
            assert not o.any() and (lse == -1e30).all()


def test_train_step_runs_each_kernel_once_per_block():
    """One bf16 train step of the full-width vit: 4 K1, 4 K2 and 4 K3
    launches, all on the tensor cores, finite gradients on every
    parameter."""
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
    tc_before = (tfa.flash_attention_fwd.tensor_core_launches,
                 tfa.flash_attention_dq.tensor_core_launches,
                 tfa.flash_attention_dkv.tensor_core_launches)
    _, m = engine.train_step(state, images, labels,
                             torch.ones(64, dtype=torch.bool, device="cuda"),
                             torch.Generator(device="cuda").manual_seed(1))
    torch.cuda.synchronize()
    got = {k: v - before[k] for k, v in kernel_launches().items()}
    assert got == {"flash_fwd": 4, "flash_dq": 4, "flash_dkv": 4,
                   "conv_dw": 0, "flash_fwd_pos": 0, "flash_dq_pos": 0,
                   "flash_dkv_pos": 0}
    assert (tfa.flash_attention_fwd.tensor_core_launches - tc_before[0],
            tfa.flash_attention_dq.tensor_core_launches - tc_before[1],
            tfa.flash_attention_dkv.tensor_core_launches - tc_before[2]) \
        == (4, 4, 4)
    assert torch.isfinite(m["loss"]).item()
    for name, p in model.named_parameters():
        assert p.grad is not None and torch.isfinite(p.grad).all(), name


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_conv_dw_kernel_matches_plain_on_card(dtype):
    """K5 at the cnn's three shapes (batch 64) and a ragged one, held to
    its plain version (1e-5 of the largest value: f32 sums in another
    order, in both dtypes since the kernel sums in f32), deterministic."""
    _need_card()
    from distributedpytorch_tpu_torch.ops import conv

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    dt = getattr(torch, dtype)
    for b, h, w, ci, co in ((64, 28, 28, 32, 32), (64, 14, 14, 32, 64),
                            (64, 14, 14, 64, 64), (3, 9, 7, 32, 48)):
        x = torch.randn((b, h, w, ci), generator=gen, device="cuda").to(dt)
        dy = torch.randn((b, h, w, co), generator=gen, device="cuda").to(dt)
        before = conv.conv3x3_dw.launches
        got = conv.conv3x3_dw(x, dy)
        again = conv.conv3x3_dw(x, dy)
        torch.cuda.synchronize()
        assert conv.conv3x3_dw.launches == before + 2
        assert torch.equal(got, again)
        ref = conv.conv3x3_dw_plain(x, dy)
        assert (got - ref).abs().max().item() \
            <= 1e-5 * ref.abs().max().item()


def test_conv_dw_routes_match_plain_on_card():
    """K5's two routes in bf16: the cnn's shapes and a ragged one take the
    tensor cores by the rule (the scalar kernel forced beside them), a
    shape with channels not multiples of 8 the scalar kernel; each within
    1e-5 of the plain version's largest value, two calls bit-identical.
    Forcing the tensor cores on that shape raises."""
    _need_card()
    from distributedpytorch_tpu_torch.ops import conv

    gen = torch.Generator(device="cuda").manual_seed(1)
    for b, h, w, ci, co in ((64, 28, 28, 32, 32), (64, 14, 14, 32, 64),
                            (64, 14, 14, 64, 64), (5, 13, 11, 40, 24),
                            (2, 9, 7, 36, 20)):
        x = torch.randn((b, h, w, ci), generator=gen,
                        device="cuda").to(torch.bfloat16)
        dy = torch.randn((b, h, w, co), generator=gen,
                         device="cuda").to(torch.bfloat16)
        tc = ci % 8 == 0 and co % 8 == 0
        before = (conv.conv3x3_dw.launches,
                  conv.conv3x3_dw.tensor_core_launches)
        runs = {tc: (conv.conv3x3_dw(x, dy), conv.conv3x3_dw(x, dy))}
        assert (conv.conv3x3_dw.launches,
                conv.conv3x3_dw.tensor_core_launches) == (
                    before[0] + 2, before[1] + 2 * tc)
        if tc:
            runs[False] = (conv._launch(x, dy, tensor_core=False),
                           conv._launch(x, dy, tensor_core=False))
        else:
            with pytest.raises(RuntimeError, match="tensor-core kernel"):
                conv._launch(x, dy, tensor_core=True)
        torch.cuda.synchronize()
        ref = conv.conv3x3_dw_plain(x, dy)
        for got, again in runs.values():
            assert torch.equal(got, again)
            assert (got - ref).abs().max().item() \
                <= 1e-5 * ref.abs().max().item()


def test_cnn_train_step_launches_k5_three_times():
    """One bf16 train step of the cnn with pallas_dw=True: 3 K5 launches
    (Conv_1..Conv_3), all on the tensor cores, finite gradients; none in
    an eval step."""
    _need_card()
    from distributedpytorch_tpu_torch.ops import conv

    policy = PRESETS["bf16"]
    model = get_model("cnn", 10, policy, device="cuda", pallas_dw=True)
    engine = Engine(model, cross_entropy, 0.13, 0.31, 28, policy, "cuda")
    state = engine.init_state(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    images = torch.from_numpy(rng.integers(0, 256, (64, 28, 28),
                                           dtype=np.uint8)).cuda()
    labels = torch.from_numpy(rng.integers(0, 10, 64)).cuda()
    valid = torch.ones(64, dtype=torch.bool, device="cuda")
    before = conv.conv3x3_dw.launches
    tc_before = conv.conv3x3_dw.tensor_core_launches
    _, m = engine.train_step(state, images, labels, valid,
                             torch.Generator(device="cuda").manual_seed(1))
    engine.eval_step(state, images, labels, valid)
    torch.cuda.synchronize()
    assert conv.conv3x3_dw.launches - before == 3
    assert conv.conv3x3_dw.tensor_core_launches - tc_before == 3
    assert torch.isfinite(m["loss"]).item()
    for name, p in model.named_parameters():
        assert p.grad is not None and torch.isfinite(p.grad).all(), name


@pytest.mark.parametrize("precision", ["bf16", "f16"])
def test_graphed_chunks_equal_eager_epochs_on_card(precision):
    """Two chunks of two epochs of the cnn with K5 (``ChunkRunner``: the
    steps captured as CUDA Graphs and replayed) against the same four
    epochs one step at a time from the same seed: parameters, BatchNorm
    statistics, Adam's state, the counters, the loss scale and every
    epoch's sums bit-identical, and K5's launches (one capture's times
    the replays) equal."""
    _need_card()
    from distributedpytorch_tpu_torch import utils
    from distributedpytorch_tpu_torch.data.datasets import Split
    from distributedpytorch_tpu_torch.data.pipeline import ResidentLoader
    from distributedpytorch_tpu_torch.train.dispatch import ChunkRunner

    rng = np.random.default_rng(3)
    images = rng.integers(0, 256, (448, 28, 28), dtype=np.uint8)
    labels = rng.integers(0, 10, 448).astype(np.int64)
    train = ResidentLoader(Split(images[:384], labels[:384]), 64, True, 5,
                           "cuda")
    valid = ResidentLoader(Split(images[384:], labels[384:]), 64, False, 5,
                           "cuda")
    runs = []
    for chunked in (False, True):
        model = get_model("cnn", 10, PRESETS[precision], device="cuda",
                          pallas_dw=True)
        engine = Engine(model, cross_entropy, 0.45, 0.2, 28,
                        PRESETS[precision], "cuda",
                        steps_per_epoch=len(train))
        state = engine.init_state(torch.Generator().manual_seed(0))
        before = kernel_launches()["conv_dw"]
        sums = []
        if chunked:
            runner = ChunkRunner(engine, state, train, valid, 9, 2)
            for first in (0, 2):
                out = runner.run([first, first + 1])
                sums += [(m.tolist(), e.tolist())
                         for m, e in zip(out["train"], out["eval"])]
        else:
            for epoch in range(4):
                hist, evals = [], torch.zeros(4, device="cuda")
                for i, batch in enumerate(train.epoch(epoch)):
                    gen = utils.step_generator(9, epoch, i, "cuda")
                    _, m = engine.train_step(state, *batch, gen)
                    hist.append(torch.stack([m["loss"], m["correct"],
                                             m["valid"]]).tolist())
                for batch in valid.epoch(epoch):
                    m = engine.eval_step(state, *batch)
                    evals += torch.stack([m[k] for k in (
                        "loss_numer", "loss_denom", "correct", "valid")])
                sums.append((hist, evals.tolist()))
        torch.cuda.synchronize()
        runs.append((state, sums, kernel_launches()["conv_dw"] - before))
    (eager, eager_sums, n_eager), (graphed, graphed_sums, n_graphed) = runs
    for (k, v), w in zip(eager.model.state_dict().items(),
                         graphed.model.state_dict().values()):
        assert torch.equal(v, w), k
    for i, st in eager.optimizer.state_dict()["state"].items():
        for name, t in st.items():
            assert torch.equal(
                t, graphed.optimizer.state_dict()["state"][i][name])
    assert (int(eager.step), int(eager.updates)) == \
        (int(graphed.step), int(graphed.updates)) == (24, 24)
    if precision == "f16":
        assert eager.loss_scale.to_dict() == graphed.loss_scale.to_dict()
    assert eager_sums == graphed_sums
    assert n_eager == n_graphed == 3 * 24
