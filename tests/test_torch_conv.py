"""The client-batched convolution op (``repro_torch.kernels.conv``) on the
CPU, where it runs its plain version: its ``torch.func`` plumbing (the vmap
rules that fold ``vmap``'s dimension into the op's clients, the autograd
formula that calls the dgrad and wgrad ops) against the per-client
``F.pad`` + ``F.conv2d`` path the model used before, at every convolution
shape of ResNet-20/GN.  The kernels themselves are tested on the card
(``tests/test_torch_cuda.py``)."""
import pytest
import torch
import torch.nn.functional as F

from repro_torch import kernels
from repro_torch.kernels import conv, relay_mix


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    # the suite runs several test processes side by side
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


# every convolution of ResNet-20/GN: (Cin, Cout, kernel, stride); maps of 8
# (even, so the stride-2 3×3 ones pad (0, 1))
SHAPES = {
    "stem_3to16": (3, 16, 3, 1),
    "s1_16": (16, 16, 3, 1),
    "s1_32": (32, 32, 3, 1),
    "s1_64": (64, 64, 3, 1),
    "s2_16to32": (16, 32, 3, 2),
    "s2_32to64": (32, 64, 3, 2),
    "proj_16to32": (16, 32, 1, 2),
    "proj_32to64": (32, 64, 1, 2),
}
N, B, SIDE = 3, 2, 8


def _old_conv(w, x, stride):
    """One client as the model computed it before: x (B, H, W, C) NHWC, w
    HWIO, XLA's SAME padding by an F.pad copy, F.conv2d on NCHW/OIHW."""
    kh, kw = w.shape[0], w.shape[1]
    top, bottom = conv.same_pad(x.shape[1], kh, stride)
    left, right = conv.same_pad(x.shape[2], kw, stride)
    xt = F.pad(x.permute(0, 3, 1, 2), (left, right, top, bottom))
    return F.conv2d(xt, w.permute(3, 2, 0, 1), stride=stride).permute(0, 2, 3, 1)


def _new_conv(w, x, stride):
    return conv.conv2d(x[None], w[None], stride)[0]


def _inputs(name, seed=0):
    cin, cout, k, stride = SHAPES[name]
    gen = torch.Generator().manual_seed(seed + 17 * cin + cout + k + stride)
    out = -(-SIDE // stride)
    x = torch.randn(N, B, SIDE, SIDE, cin, generator=gen)
    w = torch.randn(N, k, k, cin, cout, generator=gen) * (2.0 / (k * k * cin)) ** 0.5
    r = torch.randn(N, B, out, out, cout, generator=gen)  # the loss's weights
    return x, w, r, stride


def _close(got, want):
    # both sides are oneDNN's f32 convolution with the clients as groups (the
    # op's plain version, and vmap's batching rule of F.conv2d); they may be
    # handed other strides and reorder sums, so a few ulps of the tensor's
    # scale apart at most
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * max(1.0, float(want.abs().max())))


@pytest.mark.parametrize("batched", ["both", "x_only", "w_only"])
@pytest.mark.parametrize("name", list(SHAPES))
def test_vmapped_grad_and_value_matches_pad_and_grouped_conv(name, batched):
    """vmap(grad_and_value) of a loss of one client's convolution: the op
    (its vmap rules fold vmap's clients into its own, x and w batched or
    either one) against the old per-client path, in the loss, the weight
    gradient and, but for the stem, the input gradient."""
    x, w, r, stride = _inputs(name)
    stem = x.shape[-1] == 3
    in_dims = {"both": (0, 0, 0), "x_only": (None, 0, 0), "w_only": (0, None, 0)}[batched]
    if in_dims[0] is None:
        w = w[0]
    if in_dims[1] is None:
        x = x[0]
    argnums = (0,) if stem else (0, 1)

    def loss(f):
        return lambda w_, x_, r_: (f(w_, x_, stride) * r_).square().sum()

    got_g, got_v = torch.func.vmap(torch.func.grad_and_value(loss(_new_conv), argnums=argnums),
                                   in_dims=in_dims)(w, x, r)
    want_g, want_v = torch.func.vmap(torch.func.grad_and_value(loss(_old_conv), argnums=argnums),
                                     in_dims=in_dims)(w, x, r)
    _close(got_v, want_v)
    for g, wg in zip(got_g, want_g):
        assert g.shape == wg.shape
        _close(g, wg)
    out = torch.func.vmap(lambda w_, x_: _new_conv(w_, x_, stride), in_dims=in_dims[:2])(w, x)
    _close(out, torch.func.vmap(lambda w_, x_: _old_conv(w_, x_, stride),
                                in_dims=in_dims[:2])(w, x))


@pytest.mark.parametrize("name", list(SHAPES))
def test_unbatched_call_is_one_client(name):
    """An unbatched call (the global model's evaluation) is n = 1, and plain
    autograd reaches the same gradients as the old path."""
    x, w, r, stride = _inputs(name, seed=1)
    x0, w0, r0 = x[0].clone().requires_grad_(), w[0].clone().requires_grad_(), r[0]
    got = _new_conv(w0, x0, stride)
    assert got.shape == (B, -(-SIDE // stride), -(-SIDE // stride), w.shape[-1])
    (got * r0).square().sum().backward()
    xw, ww = x[0].clone().requires_grad_(), w[0].clone().requires_grad_()
    want = _old_conv(ww, xw, stride)
    (want * r0).square().sum().backward()
    _close(got.detach(), want.detach())
    _close(w0.grad, ww.grad)
    _close(x0.grad, xw.grad)


@pytest.mark.parametrize("name", ["s2_16to32", "s2_32to64", "proj_16to32"])
def test_stride2_same_pads_after_on_even_maps(name):
    """XLA's SAME of a stride-2 conv on an even map: (0, 1) for 3×3 (nothing
    before, one after) and (0, 0) for 1×1; the op applies it in its bounds,
    and a symmetric (1, 1) is off."""
    x, w, _, stride = _inputs(name, seed=2)
    k = w.shape[1]
    assert conv.same_pad(SIDE, k, 2) == ((0, 1) if k == 3 else (0, 0))
    got = conv.conv2d(x, w, stride)
    xt, wt = x[1].permute(0, 3, 1, 2), w[1].permute(3, 2, 0, 1)
    pad = (0, 1, 0, 1) if k == 3 else (0, 0, 0, 0)
    want = F.conv2d(F.pad(xt, pad), wt, stride=2).permute(0, 2, 3, 1)
    _close(got[1], want)
    if k == 3:
        symmetric = F.conv2d(xt, wt, stride=2, padding=1).permute(0, 2, 3, 1)
        assert float((symmetric - want).abs().max()) > 0.1


def test_images_get_no_input_gradient():
    """The stem's input needs no gradient: its backward computes only the
    weight gradient (the dgrad op is never called); an input that needs one
    gets it."""
    calls = []
    real = conv.conv2d_dgrad

    def spy(*args):
        calls.append(args)
        return real(*args)

    def grads(name, argnums):
        x, w, _, stride = _inputs(name)
        return torch.func.vmap(torch.func.grad(
            lambda w_, x_: _new_conv(w_, x_, stride).sum(), argnums=argnums))(w, x)

    try:
        conv.conv2d_dgrad = spy
        g = grads("stem_3to16", 0)
        assert g.shape == (N, 3, 3, 3, 16) and not calls
        gw, gx = grads("s1_16", (0, 1))
        assert gx.shape == (N, B, SIDE, SIDE, 16) and calls
    finally:
        conv.conv2d_dgrad = real


def test_cpu_calls_count_no_launches():
    x, w, r, stride = _inputs("s1_16")
    conv.reset_launches()
    conv.conv2d(x, w, stride)
    conv.conv2d_wgrad(r, x, 3, 3, stride)
    assert conv.LAUNCHES == {"conv2d_fprop": 0, "conv2d_dgrad": 0, "conv2d_wgrad": 0}
    kernels.count_launches({"conv2d_fprop": 2})
    assert conv.LAUNCHES["conv2d_fprop"] == 2
    conv.reset_launches()


def test_one_counter_sees_every_kernel_module():
    conv.reset_launches()
    relay_mix.reset_launches()
    kernels.count_launches({"conv2d_wgrad": 3, "fused_aggregate_2d": 2})
    assert conv.LAUNCHES == {"conv2d_fprop": 0, "conv2d_dgrad": 0, "conv2d_wgrad": 3}
    assert relay_mix.LAUNCHES == {"relay_mix_2d": 0, "fused_aggregate_2d": 2}
    assert kernels.launches() == {**relay_mix.LAUNCHES, **conv.LAUNCHES}
    conv.reset_launches()  # one module's counts
    assert relay_mix.LAUNCHES["fused_aggregate_2d"] == 2
    kernels.reset_launches()  # every module's
    assert set(kernels.launches().values()) == {0}


def test_wgrad_splits_depend_on_the_pixels_alone():
    assert conv.WGRAD_SLAB == 512
    assert [conv.wgrad_splits(p) for p in (1, 512, 513, 4096, 16384, 65536)] == [
        1, 1, 2, 8, 32, 128]


def test_conv2d_refuses_mismatched_operands():
    x, w, _, stride = _inputs("s1_16")
    with pytest.raises(ValueError, match="not"):
        conv.conv2d(x[0], w[0], stride)
    with pytest.raises(ValueError, match="not"):
        conv.conv2d(x, w[:2], stride)
