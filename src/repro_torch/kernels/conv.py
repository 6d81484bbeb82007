"""ResNet-20/GN's client-batched 2-D convolutions as hand-written CUDA
kernels for Hopper, in the model's own layouts.

:func:`conv2d` takes activations ``x`` (n, B, H, W, Cin) NHWC and weights
``w`` (n, kh, kw, Cin, Cout) HWIO, the clients ``n`` an explicit leading
dimension, and returns (n, B, Ho, Wo, Cout) with XLA's ``"SAME"`` padding
(:func:`same_pad`: a stride-2 3×3 conv on an even map pads (0, 1)).  It is
differentiable under ``torch.func``: the local update's
``vmap(grad_and_value(loss))`` reaches the kernels unchanged.

* Three primitives are ``torch.library`` custom ops with a ``vmap`` rule
  that folds ``vmap``'s dimension into the op's ``n`` (x and w batched, or
  either one): ``conv2d_fprop``, ``conv2d_dgrad`` (the input gradient) and
  ``conv2d_wgrad`` (the weight gradient).
* :class:`_Conv2d`, an ``autograd.Function`` with ``setup_context`` and a
  generated vmap rule, ties them together: its backward calls the dgrad and
  wgrad ops, and skips dgrad for an input that needs no gradient (the
  images).  (``torch.library.register_autograd`` builds an
  ``autograd.Function`` that ``torch.func`` transforms refuse.)

Each primitive checks its operands and then, by device:

* CUDA: launches its kernel (``csrc/conv2d_nhwc.cu``, built at first use by
  :mod:`repro_torch.kernels.build`) on the current stream and counts it in
  :data:`LAUNCHES`.  Shapes the kernels do not take raise; there is no
  fallback to another library on the card.  wgrad's partials come from
  ``torch.empty`` on the current stream, so a CUDA graph capture takes them
  from the graph's pool.
* CPU: runs the plain version (``conv2d_*_ref``: the grouped
  ``F.conv2d`` over padded NCHW views and its gradients, the clients as
  groups), which the CPU tests compare with the JAX package.

The kernels' tiles depend on the channel count and wgrad's slabs on
B·Ho·Wo alone (:data:`WGRAD_SLAB`), never on ``n``, so a client's result is
bitwise the same whichever clients share its call.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F
from torch import Tensor

from repro_torch.kernels import build, launch_counter
from repro_torch.kernels import reset_launches as _reset_launches

# Launches of each kernel wrapper since the last reset_launches(); a CPU
# call, which runs the plain version, counts nothing.  ``conv2d_wgrad``
# counts one a call (its partial kernel and, over several slabs, the reduce).
# A graph's replays are counted by :func:`repro_torch.kernels.count_launches`.
LAUNCHES = launch_counter("conv2d_fprop", "conv2d_dgrad", "conv2d_wgrad")

# Pixels (of the B·Ho·Wo a client's weight gradient sums) one wgrad partial
# covers: ceil(B·Ho·Wo / WGRAD_SLAB) partials, added in ascending order.
# At 10 clients of 64 images the partials take 11.8 MB at every stage; 512
# was the fastest of 512, 1,024 and 2,048 on the H100 (256 would need 24 MB).
WGRAD_SLAB = 512

_WIDTHS = (16, 32, 64)  # output channels the kernels take


def reset_launches() -> None:
    _reset_launches(LAUNCHES)


def same_pad(size: int, k: int, stride: int) -> tuple[int, int]:
    """XLA's ``"SAME"`` padding (before, after) of one spatial dimension."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def wgrad_splits(pixels: int) -> int:
    """The number of slab partials wgrad sums for B·Ho·Wo = ``pixels``."""
    return -(-pixels // WGRAD_SLAB)


# -- the plain versions (CPU) -------------------------------------------------

def _nchw(x: Tensor) -> Tensor:
    """(n, B, H, W, C) → (B, n·C, H, W): the clients as channel groups."""
    n, B, H, W, C = x.shape
    return x.permute(1, 0, 4, 2, 3).reshape(B, n * C, H, W)


def _nhwc(y: Tensor, n: int) -> Tensor:
    B, nc, H, W = y.shape
    return y.reshape(B, n, nc // n, H, W).permute(1, 0, 3, 4, 2).contiguous()


def _oihw(w: Tensor) -> Tensor:
    """(n, kh, kw, Cin, Cout) → (n·Cout, Cin, kh, kw)."""
    n, kh, kw, ci, co = w.shape
    return w.permute(0, 4, 3, 1, 2).reshape(n * co, ci, kh, kw)


def _pads(H: int, W: int, kh: int, kw: int, stride: int) -> tuple[int, int, int, int]:
    """F.pad's (left, right, top, bottom)."""
    (t, b), (l, r) = same_pad(H, kh, stride), same_pad(W, kw, stride)
    return l, r, t, b


def conv2d_fprop_ref(x: Tensor, w: Tensor, stride: int) -> Tensor:
    n, _, H, W, _ = x.shape
    pads = _pads(H, W, w.shape[1], w.shape[2], stride)
    y = F.conv2d(F.pad(_nchw(x), pads), _oihw(w.to(x.dtype)), stride=stride, groups=n)
    return _nhwc(y, n)


def conv2d_dgrad_ref(dy: Tensor, w: Tensor, H: int, W: int, stride: int) -> Tensor:
    n, B = dy.shape[:2]
    kh, kw, ci = w.shape[1:4]
    l, r, t, b = _pads(H, W, kh, kw, stride)
    size = (B, n * ci, H + t + b, W + l + r)
    dxp = torch.nn.grad.conv2d_input(size, _oihw(w.to(dy.dtype)), _nchw(dy), stride=stride,
                                     groups=n)
    return _nhwc(dxp[:, :, t:t + H, l:l + W], n)


def conv2d_wgrad_ref(dy: Tensor, x: Tensor, kh: int, kw: int, stride: int) -> Tensor:
    n, _, H, W, ci = x.shape
    co = dy.shape[-1]
    xp = F.pad(_nchw(x), _pads(H, W, kh, kw, stride))
    dw = torch.nn.grad.conv2d_weight(xp, (n * co, ci, kh, kw), _nchw(dy), stride=stride,
                                     groups=n)
    return dw.reshape(n, co, ci, kh, kw).permute(0, 3, 4, 2, 1).contiguous()


# -- the kernels (CUDA) -------------------------------------------------------

def _shape(n, B, H, W, cin, cout, kh, kw, stride) -> ctypes.Array:
    """The launchers' 13 ints: n, B, H, W, Cin, Cout, kh, kw, stride, Ho,
    Wo, pad top, pad left."""
    return (ctypes.c_int * 13)(n, B, H, W, cin, cout, kh, kw, stride, -(-H // stride),
                               -(-W // stride), same_pad(H, kh, stride)[0],
                               same_pad(W, kw, stride)[0])


def _check_cuda(name: str, tensors: dict, *, n, B, H, W, cin, cout, kh, kw, stride,
                width: int, vec_in: int | None) -> None:
    """Raise on operands the kernel does not take."""
    dev = None
    for label, t in tensors.items():
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: {label} must be float32 on the card, got {t.dtype}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: {label} must be contiguous and 16-byte aligned")
        if dev is not None and t.device != dev:
            raise ValueError(f"{name}: operands on {dev} and {t.device}")
        dev = t.device
    if width not in _WIDTHS:
        raise ValueError(f"{name}: {width} output channels; the kernel takes {_WIDTHS}")
    if vec_in is not None and cin % vec_in and cout != 16:
        raise ValueError(f"{name}: Cin = {cin} must be a multiple of {vec_in} (or Cout 16)")
    if name == "conv2d_dgrad" and cout % 8:
        raise ValueError(f"{name}: Cout = {cout} must be a multiple of 8")
    if not (1 <= n <= 65535 and 1 <= B < 2**15 and 1 <= H <= 120 and 1 <= W <= 120
            and 1 <= kh <= 3 and 1 <= kw <= 3 and stride in (1, 2)):
        raise ValueError(f"{name}: unsupported shape n={n} B={B} {H}×{W} k={kh}×{kw} "
                         f"stride={stride}")


def _run(name: str, *args) -> None:
    """``{name}_launch(*args, stream)`` on the current stream; raises on an
    error."""
    dev = torch.cuda.current_device()
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = getattr(build.library(), f"{name}_launch")(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with error {err}")
    LAUNCHES[name] += 1


@torch.library.custom_op("repro_torch::conv2d_fprop", mutates_args=())
def conv2d_fprop(x: Tensor, w: Tensor, stride: int) -> Tensor:
    """y (n, B, Ho, Wo, Cout) = SAME conv of x (n, B, H, W, Cin) with w
    (n, kh, kw, Cin, Cout), per client."""
    if x.device.type == "cpu":
        return conv2d_fprop_ref(x, w, stride)
    n, B, H, W, cin = x.shape
    kh, kw, _, cout = w.shape[1:]
    _check_cuda("conv2d_fprop", {"x": x, "w": w}, n=n, B=B, H=H, W=W, cin=cin, cout=cout,
                kh=kh, kw=kw, stride=stride, width=cout, vec_in=8)
    y = torch.empty((n, B, -(-H // stride), -(-W // stride), cout), dtype=x.dtype,
                    device=x.device)
    with torch.cuda.device(x.device):
        _run("conv2d_fprop", x.data_ptr(), w.data_ptr(), y.data_ptr(),
             _shape(n, B, H, W, cin, cout, kh, kw, stride))
    return y


@torch.library.custom_op("repro_torch::conv2d_dgrad", mutates_args=())
def conv2d_dgrad(dy: Tensor, w: Tensor, H: int, W: int, stride: int) -> Tensor:
    """dx (n, B, H, W, Cin), the gradient of :func:`conv2d_fprop` in x."""
    if dy.device.type == "cpu":
        return conv2d_dgrad_ref(dy, w, H, W, stride)
    n, B = dy.shape[:2]
    kh, kw, cin, cout = w.shape[1:]
    _check_cuda("conv2d_dgrad", {"dy": dy, "w": w}, n=n, B=B, H=H, W=W, cin=cin, cout=cout,
                kh=kh, kw=kw, stride=stride, width=cin, vec_in=None)
    dx = torch.empty((n, B, H, W, cin), dtype=dy.dtype, device=dy.device)
    with torch.cuda.device(dy.device):
        _run("conv2d_dgrad", dy.data_ptr(), w.data_ptr(), dx.data_ptr(),
             _shape(n, B, H, W, cin, cout, kh, kw, stride))
    return dx


@torch.library.custom_op("repro_torch::conv2d_wgrad", mutates_args=())
def conv2d_wgrad(dy: Tensor, x: Tensor, kh: int, kw: int, stride: int) -> Tensor:
    """dw (n, kh, kw, Cin, Cout), the gradient of :func:`conv2d_fprop` in w:
    per client, ceil(B·Ho·Wo / WGRAD_SLAB) slab partials added in ascending
    order."""
    if x.device.type == "cpu":
        return conv2d_wgrad_ref(dy, x, kh, kw, stride)
    n, B, H, W, cin = x.shape
    cout = dy.shape[-1]
    _check_cuda("conv2d_wgrad", {"dy": dy, "x": x}, n=n, B=B, H=H, W=W, cin=cin, cout=cout,
                kh=kh, kw=kw, stride=stride, width=cout, vec_in=4)
    dw = torch.empty((n, kh, kw, cin, cout), dtype=x.dtype, device=x.device)
    splits = wgrad_splits(dy.shape[1] * dy.shape[2] * dy.shape[3])
    # on the current stream: a capture takes them from the graph's pool
    partials = (torch.empty((n, splits, kh * kw * cin * cout), dtype=torch.float32,
                            device=x.device) if splits > 1 else dw)
    with torch.cuda.device(x.device):
        _run("conv2d_wgrad", x.data_ptr(), dy.data_ptr(), dw.data_ptr(), partials.data_ptr(),
             _shape(n, B, H, W, cin, cout, kh, kw, stride), WGRAD_SLAB, splits)
    return dw


def _fold(info, dims, tensors):
    """Each tensor with ``vmap``'s dimension (or broadcast to it, where it
    has none) moved to the front and folded into the clients: (V, n, ...) →
    (V·n, ...), contiguous."""
    V = info.batch_size
    out = []
    for t, d in zip(tensors, dims):
        t = t.expand(V, *t.shape) if d is None else t.movedim(d, 0)
        out.append(t.reshape(V * t.shape[1], *t.shape[2:]).contiguous())
    return V, out


def _unfold(V, y):
    return y.reshape(V, y.shape[0] // V, *y.shape[1:]), 0


@conv2d_fprop.register_vmap
def _fprop_vmap(info, in_dims, x, w, stride):
    V, (x, w) = _fold(info, in_dims[:2], (x, w))
    return _unfold(V, conv2d_fprop(x, w, stride))


@conv2d_dgrad.register_vmap
def _dgrad_vmap(info, in_dims, dy, w, H, W, stride):
    V, (dy, w) = _fold(info, in_dims[:2], (dy, w))
    return _unfold(V, conv2d_dgrad(dy, w, H, W, stride))


@conv2d_wgrad.register_vmap
def _wgrad_vmap(info, in_dims, dy, x, kh, kw, stride):
    V, (dy, x) = _fold(info, in_dims[:2], (dy, x))
    return _unfold(V, conv2d_wgrad(dy, x, kh, kw, stride))


class _Conv2d(torch.autograd.Function):
    generate_vmap_rule = True

    @staticmethod
    def forward(x, w, stride):
        return conv2d_fprop(x, w, stride)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, w, stride = inputs
        ctx.save_for_backward(x, w)
        ctx.stride = stride

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dy = dy.contiguous()
        # the primitives have no gradient of their own: call them below
        # autograd (torch.func's grad keeps grad mode on in a backward)
        with torch.no_grad():
            dx = (conv2d_dgrad(dy, w, x.shape[2], x.shape[3], ctx.stride)
                  if ctx.needs_input_grad[0] else None)
            dw = (conv2d_wgrad(dy, x, w.shape[1], w.shape[2], ctx.stride)
                  if ctx.needs_input_grad[1] else None)
        return dx, dw, None


def conv2d(x: Tensor, w: Tensor, stride: int = 1) -> Tensor:
    """SAME convolution of x (n, B, H, W, Cin) NHWC with w (n, kh, kw, Cin,
    Cout) HWIO, client by client → (n, B, Ho, Wo, Cout); differentiable in
    both under autograd and ``torch.func``."""
    if x.dim() != 5 or w.dim() != 5 or x.shape[0] != w.shape[0] or x.shape[-1] != w.shape[3]:
        raise ValueError(f"conv2d: x {tuple(x.shape)} and w {tuple(w.shape)} are not "
                         "(n, B, H, W, Cin) and (n, kh, kw, Cin, Cout)")
    return _Conv2d.apply(x, w, stride)


def conv2d_plan(direction: str, x_shape, w_shape, stride: int) -> dict:
    """The launch a direction (``"fprop"``, ``"dgrad"``, ``"wgrad"``) makes
    for x (n, B, H, W, Cin) and w (n, kh, kw, Cin, Cout): ``rows`` (output
    pixels a block, or (tap, channel) rows for wgrad), ``grid`` (x, y, z:
    pixel tiles, parity classes or slabs, clients) and ``threads``.
    Launches nothing."""
    n, B, H, W, cin = x_shape
    kh, kw, _, cout = w_shape[1:]
    code = {"fprop": 0, "dgrad": 1, "wgrad": 2}[direction]
    splits = wgrad_splits(B * -(-H // stride) * -(-W // stride))
    plan = (ctypes.c_int * 5)()
    err = build.library().conv2d_plan(code, _shape(n, B, H, W, cin, cout, kh, kw, stride),
                                      splits, plan)
    if err != 0:
        raise ValueError(f"conv2d_plan: the {direction} kernel does not take this shape")
    return {"rows": plan[0], "grid": (plan[1], plan[2], plan[3]), "threads": plan[4]}
