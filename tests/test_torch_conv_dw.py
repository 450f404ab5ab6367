"""Kernel K5's plain version and the conv whose backward uses it, held
against the JAX package's ``ops/conv.py`` (the Pallas ``_dw_kernel`` in
interpret mode on the CPU): ``conv3x3_dw`` at the shapes of
``tests/test_conv_dw.py``, and the forward, dx and dW of ``conv3x3_same``
in f32 and bf16.  Inputs come from numpy with a seed.  Tolerances: 1e-5
relative to the largest value in f32 (the same f32 sums in another
order); in bf16 one bf16 rounding of dW (trap: the JAX ``_conv_bwd`` casts
the f32 sum to the bf16 kernel dtype, and so does the port), 1e-2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributedpytorch_tpu.ops.conv import conv3x3_dw as jax_dw
from distributedpytorch_tpu.ops.conv import conv3x3_same as jax_conv
from distributedpytorch_tpu_torch.ops import conv

SHAPES = [(4, 28, 28, 32, 32), (2, 14, 14, 32, 64), (8, 14, 14, 64, 64),
          (3, 8, 8, 32, 32)]


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _inputs(shape, seed=0):
    b, h, w, ci, co = shape
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, h, w, ci)).astype(np.float32),
            rng.standard_normal((b, h, w, co)).astype(np.float32),
            (rng.standard_normal((3, 3, ci, co)) * 0.1).astype(np.float32))


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_plain_dw_matches_jax_kernel(shape):
    x, dy, _ = _inputs(shape)
    want = np.asarray(jax_dw(jnp.asarray(x), jnp.asarray(dy)))
    got = conv.conv3x3_dw(torch.from_numpy(x), torch.from_numpy(dy))
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert _rel(got.numpy(), want) <= 1e-5


def test_plain_dw_takes_bf16_and_sums_in_f32():
    x, dy, _ = _inputs((2, 6, 5, 32, 48), seed=1)
    xb, dyb = (torch.from_numpy(a).to(torch.bfloat16) for a in (x, dy))
    want = np.asarray(jax_dw(jnp.asarray(xb.float().numpy()),
                             jnp.asarray(dyb.float().numpy())))
    got = conv.conv3x3_dw(xb, dyb)
    assert got.dtype == torch.float32
    assert _rel(got.numpy(), want) <= 1e-5


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5),
                                       ("bfloat16", 1e-2)])
@pytest.mark.parametrize("shape", SHAPES[::3], ids=str)
def test_conv3x3_same_matches_jax(shape, dtype, tol):
    """Forward, dx and dW of sum(conv(x, w) * g) on both sides."""
    x, g, w = _inputs(shape, seed=2)
    jdt = getattr(jnp, dtype)

    def loss(a, k):
        return jnp.sum(jax_conv(a.astype(jdt), k.astype(jdt))
                       .astype(jnp.float32) * g)

    want_y = np.asarray(jax_conv(jnp.asarray(x, jdt), jnp.asarray(w, jdt))
                        .astype(jnp.float32))
    want_dx, want_dw = jax.grad(loss, argnums=(0, 1))(jnp.asarray(x),
                                                      jnp.asarray(w))
    tdt = getattr(torch, dtype)
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    y = conv.conv3x3_same(xt.to(tdt), wt.to(tdt))
    (y.float() * torch.from_numpy(g)).sum().backward()
    assert y.dtype == tdt and tuple(y.shape) == want_y.shape
    assert _rel(y.detach().float().numpy(), want_y) <= tol
    assert _rel(xt.grad.numpy(), want_dx) <= tol
    assert _rel(wt.grad.numpy(), want_dw) <= tol


def test_bf16_dw_is_rounded_to_bf16_before_the_master_weight():
    """The f32 sum reaches the f32 weight as a bf16 value (JAX
    ``_conv_bwd`` casts dW to the bf16 kernel dtype)."""
    x, g, w = _inputs((2, 6, 6, 32, 32), seed=3)
    wt = torch.from_numpy(w).requires_grad_()
    y = conv.conv3x3_same(torch.from_numpy(x).to(torch.bfloat16),
                          wt.to(torch.bfloat16))
    (y.float() * torch.from_numpy(g)).sum().backward()
    assert wt.grad.dtype == torch.float32
    assert torch.equal(wt.grad, wt.grad.to(torch.bfloat16).float())


def test_hwio_oihw_round_trip():
    w = torch.arange(3 * 3 * 4 * 5, dtype=torch.float32).reshape(3, 3, 4, 5)
    oihw = conv.hwio_to_oihw(w)
    assert oihw.shape == (5, 4, 3, 3)
    assert oihw[2, 1, 0, 2] == w[0, 2, 1, 2]
    assert torch.equal(conv.oihw_to_hwio(oihw), w)


def test_channels_last_view_is_read_without_a_copy():
    """The NHWC view of a channels_last NCHW tensor has a unit channel
    stride: the wrapper takes it as it is."""
    x, dy, _ = _inputs((2, 5, 7, 32, 8), seed=4)
    xc = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)
    view = xc.permute(0, 2, 3, 1)
    assert view.stride(3) == 1 and view.data_ptr() == xc.data_ptr()
    assert torch.equal(conv.conv3x3_dw(view, torch.from_numpy(dy)),
                       conv.conv3x3_dw(torch.from_numpy(x),
                                       torch.from_numpy(dy)))


@pytest.mark.parametrize("make,match", [
    (lambda x, dy: (x.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1),
                    dy), "channel dim of x contiguous"),
    (lambda x, dy: (x, dy[..., ::2]), "channel dim of dy contiguous"),
    (lambda x, dy: (x.double(), dy.double()),
     "float32, bfloat16 or float16"),
    (lambda x, dy: (x, dy.to(torch.bfloat16)), "of one dtype"),
    (lambda x, dy: (x[:, :4], dy), "of one \\(B, H, W\\)"),
    (lambda x, dy: (x[0], dy[0]), "of one \\(B, H, W\\)"),
], ids=["x-stride", "dy-stride", "f64", "mixed", "shape", "rank3"])
def test_wrapper_refuses_bad_strides_and_dtypes(make, match):
    x = torch.zeros((2, 5, 5, 32))
    dy = torch.zeros((2, 5, 5, 16))
    with pytest.raises(ValueError, match=match):
        conv.conv3x3_dw(*make(x, dy))


def test_split_plan_covers_the_rows_in_whole_chunks():
    for n, rows, cols in ((50176, 288, 32), (12544, 288, 64),
                          (12544, 576, 64), (784, 288, 32), (189, 288, 48),
                          (1, 27, 8)):
        splits, per = conv.split_plan(n, rows, cols)
        assert per % conv.TILE_ROWS == 0 and splits >= 1
        assert (splits - 1) * per < n <= splits * per
    assert conv.split_plan(50176, 288, 32) == (53, 960)


def _NHWC(b, h, w, c):
    """The strides of a contiguous (b, h, w, c) tensor."""
    return (h * w * c, w * c, c, 1)


@pytest.mark.parametrize("dtype,ci,co,xs,ys,xp,yp,want", [
    (torch.bfloat16, 32, 32, _NHWC(64, 28, 28, 32), _NHWC(64, 28, 28, 32),
     0, 4096, True),
    (torch.bfloat16, 64, 64, _NHWC(64, 14, 14, 64), _NHWC(64, 14, 14, 64),
     256, 512, True),
    (torch.bfloat16, 40, 24, _NHWC(5, 13, 11, 40), _NHWC(5, 13, 11, 24),
     16, 32, True),
    (torch.float32, 32, 32, _NHWC(64, 28, 28, 32), _NHWC(64, 28, 28, 32),
     0, 4096, False),
    (torch.bfloat16, 36, 32, _NHWC(2, 9, 7, 36), _NHWC(2, 9, 7, 32),
     0, 4096, False),
    (torch.bfloat16, 32, 20, _NHWC(2, 9, 7, 32), _NHWC(2, 9, 7, 20),
     0, 4096, False),
    (torch.bfloat16, 32, 32, _NHWC(2, 9, 7, 32), _NHWC(2, 9, 7, 32),
     2, 4096, False),
    (torch.bfloat16, 32, 32, _NHWC(2, 9, 7, 32), _NHWC(2, 9, 7, 32),
     0, 4104, False),
    # the first 32 of 36 channels: whole pieces, but a row stride of 36
    (torch.bfloat16, 32, 32, _NHWC(2, 9, 7, 36), _NHWC(2, 9, 7, 32),
     0, 4096, False),
    (torch.bfloat16, 32, 32, (2020, 224, 32, 1), _NHWC(2, 9, 7, 32),
     0, 4096, False),
], ids=["conv1", "conv3", "ci40-co24", "f32", "ci36", "co20", "x-ptr",
        "dy-ptr", "x-row-stride", "x-batch-stride"])
def test_tensor_core_route_rule(dtype, ci, co, xs, ys, xp, yp, want):
    """The rule between K5's routes is a pure function of dtype, channel
    counts, strides and alignment: the tensor cores take bf16 whose every
    pixel's channel run is whole, aligned 16-byte copies."""
    assert conv.tensor_core_route(dtype, ci, co, xs, ys, xp, yp) is want


def test_route_rule_takes_the_cnns_channels_last_views():
    """The cnn's activations and gradients (channels_last NCHW, read as
    NHWC views) fit the tensor-core route; a channel slice does not."""
    for ci, co in ((32, 32), (32, 64), (64, 64)):
        x = torch.zeros((2, ci, 14, 14), dtype=torch.bfloat16).contiguous(
            memory_format=torch.channels_last).permute(0, 2, 3, 1)
        dy = torch.zeros((2, co, 14, 14), dtype=torch.bfloat16).contiguous(
            memory_format=torch.channels_last).permute(0, 2, 3, 1)
        assert conv.tensor_core_route(x.dtype, ci, co, x.stride(),
                                      dy.stride(), 0, 0)
        assert not conv.tensor_core_route(x.dtype, ci - 4, co,
                                          x[..., 4:].stride(), dy.stride(),
                                          0, 0)


@pytest.mark.parametrize("n,ci,co", [
    (50176, 32, 32), (12544, 32, 64), (12544, 64, 64), (784, 32, 32),
    (189, 32, 48), (715, 40, 24), (126, 32, 32), (64, 96, 96), (1, 8, 8)],
    ids=str)
def test_mma_plan_covers_the_rows_in_whole_chunks(n, ci, co):
    tci, tco, splits, per = conv.mma_plan(n, ci, co)
    assert tci in conv.MMA_TILES and tco in conv.MMA_TILES
    assert -(-ci // tci) * tci - ci < 32
    assert per % conv.MMA_CHUNK == 0 and splits >= 1
    assert (splits - 1) * per < n <= splits * per
    tiles = 9 * -(-ci // tci) * -(-co // tco)
    assert splits == 1 or tiles * (splits - 1) < conv.TARGET_BLOCKS


def test_mma_plan_at_the_cnns_shapes():
    assert conv.mma_plan(50176, 32, 32) == (32, 32, 30, 1728)
    assert conv.mma_plan(12544, 32, 64) == (32, 64, 28, 448)
    assert conv.mma_plan(12544, 64, 64) == (64, 64, 28, 448)
    assert [conv.mma_tile(c) for c in (8, 32, 40, 64, 96, 100)] == \
        [32, 32, 64, 64, 32, 64]
