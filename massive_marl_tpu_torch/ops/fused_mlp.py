"""Fused Dense -> ELU -> LayerNorm block, forward and backward, on the
hand-written kernels of csrc/fused_mlp.cu, and the whole MLPBase tower on
those of csrc/fused_tower.cu (counterpart of
massive_marl_tpu/ops/fused_mlp.py).

One block computes, per agent n and row r,

    xt = bf16(xhat * g0 + b0)                     (the input affine)
    h  = xt @ bf16(W) + b                         (f32 product)
    a  = where(h > 0, h, exp(h) - 1)              (ELU, exp - 1 as the TPU kernel)
    y  = LN(a) * gamma + beta                     (population variance, eps 1e-6)

and stores y and the residual a as bf16.  The backward pass recomputes the
LayerNorm statistics from a and returns dx (bf16), dW (f32) and the f32
sums db, dgamma, dbeta, dg0, db0.  Shapes are agent-stacked: x [N, B, Din],
W [N, Din, H]; Din and H are multiples of 128 (callers pad).  x may repeat
one [B, Din] matrix for every agent (stride 0 on N), which the centralized
critic uses for its shared input.

`dense_elu_ln_fwd` / `dense_elu_ln_bwd` are the dispatch points: a CUDA
tensor goes to the kernel (or raises), a CPU tensor goes to the plain
PyTorch version below.  There is no other fallback.  `DenseEluLN` is the
autograd Function (the custom VJP of the reference) over the two.

The tower (kernels B4/B5, `mlp_tower_fwd` / `mlp_tower_bwd`, autograd
Function `MlpTower`) runs all layers of an MLPBase in one forward launch
that stores no residual, and one backward call that recomputes the
forward.  `mlp_base_stacked` takes it under FUSED_TOWER=1, as the reference
does; its roundings differ from the per-layer chain's in the backward (see
`tower_bwd_plain`).  `mlp_base_stacked_linearize` / `_tangent` are the
parameter-directional tangent of HATRPO's Fisher-vector products: plain
PyTorch from the activations of one forward on kernel B2.
"""
from __future__ import annotations

import ctypes
import os

import torch
import torch.nn.functional as F

from massive_marl_tpu_torch.ops import _build

EPS = 1e-6  # flax.linen.LayerNorm default epsilon
BF16 = torch.bfloat16


# ---------------------------------------------------------------------------
# plain versions (the kernels' arithmetic, one rounding per op)
# ---------------------------------------------------------------------------

def _input_affine(x, g0, b0):
    return (x.float() * g0[:, None, :] + b0[:, None, :]).to(BF16)


def _ln_stats(a):
    mu = a.mean(-1, keepdim=True)
    var = ((a - mu) ** 2).mean(-1, keepdim=True)
    inv = torch.rsqrt(var + EPS)
    return mu, inv


def _dense_elu_ln(xt, w16, b, g, be):
    """(y f32, a f32) of one block from its bf16 input xt.  Products of bf16
    values are exact in f32, so the f32 bmm of the upcast operands is the
    f32-accumulated bf16 product of the kernels (a bf16 bmm would round its
    output)."""
    h = torch.bmm(xt.float(), w16.float()) + b[:, None, :]
    a = torch.where(h > 0, h, torch.exp(h) - 1.0)
    mu, inv = _ln_stats(a)
    return (a - mu) * inv * g[:, None, :] + be[:, None, :], a


def _ln_elu_bwd(dy, a, g):
    """(dh f32, yhat) of one block from dy f32 and the bf16 activation a;
    the LayerNorm statistics come from the bf16 a."""
    a = a.float()
    mu, inv = _ln_stats(a)
    yhat = (a - mu) * inv
    dyh = dy * g[:, None, :]
    m1 = dyh.mean(-1, keepdim=True)
    m2 = (dyh * yhat).mean(-1, keepdim=True)
    da = (dyh - m1 - yhat * m2) * inv
    return da * torch.where(a > 0, 1.0, a + 1.0), yhat


def fwd_plain(x, w16, b, g, be, g0, b0):
    """(y, a), both [N, B, H] bf16."""
    y, a = _dense_elu_ln(_input_affine(x, g0, b0), w16, b, g, be)
    return y.to(BF16), a.to(BF16)


def bwd_plain(dy, a, x, w16, g, g0, b0):
    """(dx bf16, dW f32, db, dgamma, dbeta, dg0, db0 f32) from dy bf16."""
    dy = dy.float()
    xt = _input_affine(x, g0, b0)
    dh, yhat = _ln_elu_bwd(dy, a, g)
    dh16 = dh.to(BF16)
    dx_raw = torch.bmm(dh16.float(), w16.float().transpose(1, 2))
    dx = (dx_raw * g0[:, None, :]).to(BF16)
    dw = torch.bmm(xt.float().transpose(1, 2), dh16.float())
    return (dx, dw, dh.sum(1), (dy * yhat).sum(1), dy.sum(1),
            (dx_raw * x.float()).sum(1), dx_raw.sum(1))


def tower_fwd_plain(x, g0, b0, ws16, bs, gs, bes):
    """y [N, B, H] bf16 of the whole tower (kernel B4's arithmetic).  Layer
    0 applies the input affine bf16(x*g0 + b0); hidden layers apply none;
    each layer's next input is bf16(y) of its f32 y.  So y equals the
    per-layer chain of fwd_plain (hidden layers with ones/zeros) bit for
    bit."""
    h = _input_affine(x, g0, b0)
    for w16, b, g, be in zip(ws16, bs, gs, bes):
        h = _dense_elu_ln(h, w16, b, g, be)[0].to(BF16)
    return h


def tower_bwd_plain(dy, x, g0, b0, ws16, bs, gs, bes, need_dx: bool = False):
    """(dx, dWs, dbs, dgammas, dbetas, dg0, db0) of the whole tower (kernel
    B5's arithmetic); the lists run over the layers.  Where it rounds, and
    where that differs from chaining bwd_plain:
      * the forward is recomputed; each layer keeps its input x_l (bf16:
        layer 0's bf16(x*g0 + b0), then bf16(y) of the layer before) and its
        activation a_l rounded to bf16, and the backward takes the
        LayerNorm statistics from that bf16 a_l;
      * only the last layer's dy comes in as bf16.  Between layers the
        cotangent dh16_l @ W_l^T stays f32, where bwd_plain stores dx as
        bf16, and dgamma_l = sum dy * yhat uses that f32 dy;
      * layer 0's dx_raw = dh16_0 @ W_0^T is always computed, because dg0 =
        sum dx_raw * x and db0 = sum dx_raw need it; dx = bf16(dx_raw * g0)
        is returned only when need_dx (else None)."""
    L = len(ws16)
    xs, acts = [_input_affine(x, g0, b0)], []
    for li in range(L):
        y, a = _dense_elu_ln(xs[li], ws16[li], bs[li], gs[li], bes[li])
        acts.append(a.to(BF16))
        if li < L - 1:
            xs.append(y.to(BF16))
    dy = dy.float()
    dws, dbs, dgs, dbes = [None] * L, [None] * L, [None] * L, [None] * L
    for li in reversed(range(L)):
        dh, yhat = _ln_elu_bwd(dy, acts[li], gs[li])
        dh16 = dh.to(BF16).float()
        dws[li] = torch.bmm(xs[li].float().transpose(1, 2), dh16)
        dbs[li], dgs[li], dbes[li] = dh.sum(1), (dy * yhat).sum(1), dy.sum(1)
        dy = torch.bmm(dh16, ws16[li].float().transpose(1, 2))
    dx = (dy * g0[:, None, :]).to(BF16) if need_dx else None
    return dx, dws, dbs, dgs, dbes, (dy * x.float()).sum(1), dy.sum(1)


# ---------------------------------------------------------------------------
# kernels (csrc/fused_mlp.cu)
# ---------------------------------------------------------------------------

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_PP = ctypes.POINTER(ctypes.c_void_p)   # a host array of device pointers
fused_mlp_lib = _build.CudaLib("fused_mlp.cu", {
    "dense_elu_ln_fwd": ([_I] * 4 + [_LL] + [_P] * 10, _I),
    "dense_elu_ln_bwd_scratch": ([_I] * 4, _LL),
    "dense_elu_ln_bwd": ([_I] * 4 + [_LL] + [_P] * 13, _I),
    "mlp_fwd_cluster_blocks": ([], _I),
})
fused_tower_lib = _build.CudaLib("fused_tower.cu", {
    "mlp_tower_fwd": ([_I] * 5 + [_LL] + [_P] * 3 + [_PP] * 4 + [_P] * 2, _I),
    "mlp_tower_bwd_scratch": ([_I] * 5, _LL),
    "mlp_tower_bwd": ([_I] * 5 + [_LL] + [_P] * 4 + [_PP] * 4 + [_P, _PP] + [_P] * 4, _I),
})


def _check(name, t, shape, dtype, dev, kind="dense_elu_ln"):
    if t.device != dev or t.dtype != dtype or tuple(t.shape) != tuple(shape) \
            or not t.is_contiguous():
        raise ValueError(f"{kind} kernel: {name} must be a contiguous {dtype} "
                         f"{tuple(shape)} tensor on {dev}, got {t.dtype} "
                         f"{tuple(t.shape)} (contiguous={t.is_contiguous()}) on {t.device}")


def _check_x(x, N, B, Din, dev, kind="dense_elu_ln"):
    """x [N, B, Din] bf16, rows contiguous; the agent stride is B*Din or 0."""
    if x.device != dev or x.dtype != BF16 or tuple(x.shape) != (N, B, Din) \
            or x.stride(2) != 1 or x.stride(1) != Din or x.stride(0) not in (0, B * Din):
        raise ValueError(f"{kind} kernel: x must be a bf16 ({N}, {B}, {Din}) tensor "
                         f"on {dev} with rows contiguous, got {x.dtype} {tuple(x.shape)} "
                         f"strides {x.stride()} on {x.device}")
    return x.stride(0)


def _check_aligned(kind, **ts):
    """The forward kernels copy g0 and b0 into shared memory with bulk copies,
    which need 16-byte-aligned sources: a misaligned view would fault."""
    for name, t in ts.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{kind} kernel: {name} must start at a 16-byte-aligned "
                             f"address, got {t.data_ptr():#x}")


def _check_dims(Din, H):
    if Din % 128 or H not in (128, 256, 384, 512):
        raise ValueError(f"dense_elu_ln kernel takes Din a multiple of 128 and H in "
                         f"(128, 256, 384, 512), got Din={Din}, H={H}")


class DenseEluLnFwdKernel:
    """Kernel B2 (one launch of a persistent grid of thread-block clusters).
    `launches` counts kernel launches and nothing else."""

    def __init__(self):
        self.launches = 0

    def __call__(self, x, w16, b, g, be, g0, b0):
        dev = w16.device
        if dev.type != "cuda":
            raise ValueError("the dense_elu_ln kernels take CUDA tensors")
        N, Din, H = w16.shape
        B = x.shape[1]
        _check_dims(Din, H)
        sx = _check_x(x, N, B, Din, dev)
        _check("w16", w16, (N, Din, H), BF16, dev)
        for name, t, d in (("b", b, H), ("gamma", g, H), ("beta", be, H),
                           ("gamma0", g0, Din), ("beta0", b0, Din)):
            _check(name, t, (N, d), torch.float32, dev)
        _check_aligned("dense_elu_ln", gamma0=g0, beta0=b0)
        lib = fused_mlp_lib.load()
        y = torch.empty((N, B, H), dtype=BF16, device=dev)
        a = torch.empty((N, B, H), dtype=BF16, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.dense_elu_ln_fwd(N, B, Din, H, sx, x.data_ptr(), w16.data_ptr(),
                                   b.data_ptr(), g.data_ptr(), be.data_ptr(), g0.data_ptr(),
                                   b0.data_ptr(), y.data_ptr(), a.data_ptr(), stream)
        if err != 0:
            raise RuntimeError(f"dense_elu_ln_fwd launch failed with CUDA error {err}")
        self.launches += 1
        return y, a


class DenseEluLnBwdKernel:
    """Kernel B3 (a row pass, a dW pass and a fixed-order reduction of the
    partial sums, launched together).  `launches` counts calls that launch
    it and nothing else.  With need_dx False, dx is not stored (None)."""

    def __init__(self):
        self.launches = 0

    def __call__(self, dy, a, x, w16, g, g0, b0, need_dx: bool = True):
        dev = w16.device
        if dev.type != "cuda":
            raise ValueError("the dense_elu_ln kernels take CUDA tensors")
        N, Din, H = w16.shape
        B = x.shape[1]
        _check_dims(Din, H)
        sx = _check_x(x, N, B, Din, dev)
        _check("dy", dy, (N, B, H), BF16, dev)
        _check("a", a, (N, B, H), BF16, dev)
        _check("w16", w16, (N, Din, H), BF16, dev)
        for name, t, d in (("gamma", g, H), ("gamma0", g0, Din), ("beta0", b0, Din)):
            _check(name, t, (N, d), torch.float32, dev)
        lib = fused_mlp_lib.load()
        f32 = torch.float32
        dx = torch.empty((N, B, Din), dtype=BF16, device=dev) if need_dx else None
        dw = torch.empty((N, Din, H), dtype=f32, device=dev)
        vec_h = torch.empty((3, N, H), dtype=f32, device=dev)      # db, dgamma, dbeta
        vec_d = torch.empty((2, N, Din), dtype=f32, device=dev)    # dg0, db0
        scratch = torch.empty(lib.dense_elu_ln_bwd_scratch(N, B, Din, H),
                              dtype=torch.uint8, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.dense_elu_ln_bwd(
            N, B, Din, H, sx, dy.data_ptr(), a.data_ptr(), x.data_ptr(), w16.data_ptr(),
            g.data_ptr(), g0.data_ptr(), b0.data_ptr(), 0 if dx is None else dx.data_ptr(),
            dw.data_ptr(), vec_h.data_ptr(), vec_d.data_ptr(), scratch.data_ptr(), stream)
        if err != 0:
            raise RuntimeError(f"dense_elu_ln_bwd launch failed with CUDA error {err}")
        self.launches += 1
        return dx, dw, vec_h[0], vec_h[1], vec_h[2], vec_d[0], vec_d[1]


fwd_kernel = DenseEluLnFwdKernel()
bwd_kernel = DenseEluLnBwdKernel()


def dense_elu_ln_fwd(x, w16, b, g, be, g0, b0):
    """(y, a): the kernel for CUDA tensors, the plain version for CPU ones."""
    if w16.device.type == "cuda":
        return fwd_kernel(x, w16, b, g, be, g0, b0)
    if w16.device.type == "cpu":
        return fwd_plain(x, w16, b, g, be, g0, b0)
    raise ValueError(f"no dense_elu_ln for device {w16.device}")


def dense_elu_ln_bwd(dy, a, x, w16, g, g0, b0, need_dx: bool = True):
    """(dx, dW, db, dgamma, dbeta, dg0, db0); dx is None when not needed."""
    if w16.device.type == "cuda":
        return bwd_kernel(dy, a, x, w16, g, g0, b0, need_dx)
    if w16.device.type == "cpu":
        out = bwd_plain(dy, a, x, w16, g, g0, b0)
        return (out[0] if need_dx else None,) + out[1:]
    raise ValueError(f"no dense_elu_ln for device {w16.device}")


class DenseEluLN(torch.autograd.Function):
    """y = LN(elu((x*gamma0 + beta0) @ w + b)) * gamma + beta, agent-stacked
    (the custom VJP `dense_elu_ln` of the reference).

    x [N,B,Din] bf16: for the first layer the pre-normalized features
    (feature_norm) with gamma0/beta0 [N,Din] the feature LayerNorm's
    learnables; for hidden layers ones/zeros.  w [N,Din,H] f32 master
    weights (cast to bf16 once; dW comes back f32); b/gamma/beta [N,H] f32.
    Returns y [N,B,H] bf16.  The backward pass takes dy as bf16."""

    @staticmethod
    def forward(ctx, x, w, b, gamma, beta, gamma0, beta0):
        w16 = w.to(BF16)
        y, a = dense_elu_ln_fwd(x, w16, b, gamma, beta, gamma0, beta0)
        ctx.save_for_backward(x, w16, gamma, gamma0, beta0, a)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, w16, gamma, gamma0, beta0, a = ctx.saved_tensors
        return dense_elu_ln_bwd(dy.to(BF16).contiguous(), a, x, w16, gamma, gamma0, beta0,
                                need_dx=ctx.needs_input_grad[0])


def dense_elu_ln(x, w, b, gamma, beta, gamma0, beta0):
    return DenseEluLN.apply(x, w, b, gamma, beta, gamma0, beta0)


# ---------------------------------------------------------------------------
# the whole tower: kernels B4/B5 (csrc/fused_tower.cu)
# ---------------------------------------------------------------------------

def _check_tower(x, g0, b0, ws16, bs, gs, bes):
    """Checks the tower's operands for the kernels; returns (N, B, Din, H,
    L, agent stride of x)."""
    dev = ws16[0].device
    if dev.type != "cuda":
        raise ValueError("the mlp_tower kernels take CUDA tensors")
    N, Din, H = ws16[0].shape
    L = len(ws16)
    if Din % 128 or Din > 512 or H not in (128, 256, 384, 512) or not 0 < L <= 8 \
            or not len(bs) == len(gs) == len(bes) == L:
        raise ValueError(f"mlp_tower kernels take Din a multiple of 128 up to 512, H in "
                         f"(128, 256, 384, 512) and 1 to 8 layers with b, gamma, beta each, "
                         f"got Din={Din}, H={H}, L={L}")
    B = x.shape[1]
    sx = _check_x(x, N, B, Din, dev, "mlp_tower")
    for li, w in enumerate(ws16):
        _check(f"w16[{li}]", w, (N, Din if li == 0 else H, H), BF16, dev, "mlp_tower")
    for name, ts in (("b", bs), ("gamma", gs), ("beta", bes)):
        for li, t in enumerate(ts):
            _check(f"{name}[{li}]", t, (N, H), torch.float32, dev, "mlp_tower")
    for name, t in (("gamma0", g0), ("beta0", b0)):
        _check(name, t, (N, Din), torch.float32, dev, "mlp_tower")
    return N, B, Din, H, L, sx


def _ptrs(ts):
    return (ctypes.c_void_p * len(ts))(*[t.data_ptr() for t in ts])


class MlpTowerFwdKernel:
    """Kernel B4.  `launches` counts kernel launches and nothing else."""

    def __init__(self):
        self.launches = 0

    def __call__(self, x, g0, b0, ws16, bs, gs, bes):
        N, B, Din, H, L, sx = _check_tower(x, g0, b0, ws16, bs, gs, bes)
        _check_aligned("mlp_tower", gamma0=g0, beta0=b0)
        dev = x.device
        lib = fused_tower_lib.load()
        y = torch.empty((N, B, H), dtype=BF16, device=dev)
        err = lib.mlp_tower_fwd(N, B, Din, H, L, sx, x.data_ptr(), g0.data_ptr(), b0.data_ptr(),
                                _ptrs(ws16), _ptrs(bs), _ptrs(gs), _ptrs(bes), y.data_ptr(),
                                torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            raise RuntimeError(f"mlp_tower_fwd launch failed with CUDA error {err}")
        self.launches += 1
        return y


class MlpTowerBwdKernel:
    """Kernel B5 (a row pass, a dW pass per layer and fixed-order
    reductions, launched together).  `launches` counts calls that launch it
    and nothing else.  With need_dx False, dx is not stored (None)."""

    def __init__(self):
        self.launches = 0

    def __call__(self, dy, x, g0, b0, ws16, bs, gs, bes, need_dx: bool = False):
        N, B, Din, H, L, sx = _check_tower(x, g0, b0, ws16, bs, gs, bes)
        dev = x.device
        _check("dy", dy, (N, B, H), BF16, dev, "mlp_tower")
        lib = fused_tower_lib.load()
        f32 = torch.float32
        dx = torch.empty((N, B, Din), dtype=BF16, device=dev) if need_dx else None
        dws = [torch.empty(w.shape, dtype=f32, device=dev) for w in ws16]
        vec_h = torch.empty((3 * L, N, H), dtype=f32, device=dev)  # db, dgamma, dbeta per layer
        vec_d = torch.empty((2, N, Din), dtype=f32, device=dev)    # dg0, db0
        scratch = torch.empty(lib.mlp_tower_bwd_scratch(N, B, Din, H, L),
                              dtype=torch.uint8, device=dev)
        err = lib.mlp_tower_bwd(
            N, B, Din, H, L, sx, dy.data_ptr(), x.data_ptr(), g0.data_ptr(), b0.data_ptr(),
            _ptrs(ws16), _ptrs(bs), _ptrs(gs), _ptrs(bes), 0 if dx is None else dx.data_ptr(),
            _ptrs(dws), vec_h.data_ptr(), vec_d.data_ptr(), scratch.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            raise RuntimeError(f"mlp_tower_bwd launch failed with CUDA error {err}")
        self.launches += 1
        return (dx, dws, list(vec_h[0::3]), list(vec_h[1::3]), list(vec_h[2::3]),
                vec_d[0], vec_d[1])


tower_fwd_kernel = MlpTowerFwdKernel()
tower_bwd_kernel = MlpTowerBwdKernel()


def mlp_tower_fwd(x, g0, b0, ws16, bs, gs, bes):
    """y: kernel B4 for CUDA tensors, the plain version for CPU ones."""
    dev = ws16[0].device
    if dev.type == "cuda":
        return tower_fwd_kernel(x, g0, b0, ws16, bs, gs, bes)
    if dev.type == "cpu":
        return tower_fwd_plain(x, g0, b0, ws16, bs, gs, bes)
    raise ValueError(f"no mlp_tower for device {dev}")


def mlp_tower_bwd(dy, x, g0, b0, ws16, bs, gs, bes, need_dx: bool = False):
    """(dx, dWs, dbs, dgammas, dbetas, dg0, db0): kernel B5 for CUDA
    tensors, the plain version for CPU ones; dx is None unless need_dx."""
    dev = ws16[0].device
    if dev.type == "cuda":
        return tower_bwd_kernel(dy, x, g0, b0, ws16, bs, gs, bes, need_dx)
    if dev.type == "cpu":
        return tower_bwd_plain(dy, x, g0, b0, ws16, bs, gs, bes, need_dx)
    raise ValueError(f"no mlp_tower for device {dev}")


class MlpTower(torch.autograd.Function):
    """The whole L-layer MLPBase tower, one kernel each way (the custom VJP
    `mlp_tower` of the reference).  Inputs: x [N,B,Din] bf16 pre-normalized
    features, gamma0/beta0 [N,Din] the feature LayerNorm's learnables,
    need_dx, then the L Dense kernels [N,Din_l,H] (f32 masters, cast to bf16
    once; dW comes back f32), the L biases, the L LayerNorm scales and the L
    LayerNorm biases, each [N,H] f32.  The forward saves no residual; the
    backward recomputes it.  Without need_dx the x gradient is None."""

    @staticmethod
    def forward(ctx, x, gamma0, beta0, need_dx, *layers):
        L = len(layers) // 4
        ws16 = [w.to(BF16) for w in layers[:L]]
        bs, gs, bes = layers[L:2 * L], layers[2 * L:3 * L], layers[3 * L:]
        ctx.save_for_backward(x, gamma0, beta0, *ws16, *bs, *gs, *bes)
        ctx.L, ctx.need_dx = L, need_dx
        return mlp_tower_fwd(x, gamma0, beta0, ws16, bs, gs, bes)

    @staticmethod
    def backward(ctx, dy):
        x, g0, b0, *rest = ctx.saved_tensors
        L = ctx.L
        dx, dws, dbs, dgs, dbes, dg0, db0 = mlp_tower_bwd(
            dy.to(BF16).contiguous(), x, g0, b0, rest[:L], rest[L:2 * L], rest[2 * L:3 * L],
            rest[3 * L:], ctx.need_dx)
        return (dx, dg0, db0, None, *dws, *dbs, *dgs, *dbes)


def mlp_tower(x, gamma0, beta0, ws, bs, gs, bes, need_dx: bool = False):
    """y [N,B,H] bf16 of the whole tower through MlpTower (see there)."""
    return MlpTower.apply(x, gamma0, beta0, need_dx, *ws, *bs, *gs, *bes)


# ---------------------------------------------------------------------------
# MLPBase-equivalent stacked apply
# ---------------------------------------------------------------------------

def _pad_features(x, mult: int = 128):
    pad = (-x.shape[-1]) % mult
    return F.pad(x, (0, pad)) if pad else x


def feature_norm(x):
    """The parameter-free part of the feature LayerNorm: (x-mu)/sigma over
    the last axis (population variance), padded to a 128 multiple and cast
    bf16.  Computed once per update; the LayerNorm's learnable scale and
    bias are applied inside the first fused layer."""
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    xh = (x - mu) * torch.rsqrt(var + EPS)
    return _pad_features(xh).to(BF16)


def _pad_rows(w, din):
    """Dense kernel [N, d, H] -> [N, din, H] with zero rows."""
    return F.pad(w, (0, 0, 0, din - w.shape[1])) if w.shape[1] != din else w


def _input_ln(params: dict, din: int):
    """The feature LayerNorm's scale and bias, padded with zeros to din."""
    ln0 = params["LayerNorm_0"]
    pad = din - ln0["scale"].shape[-1]
    return F.pad(ln0["scale"], (0, pad)), F.pad(ln0["bias"], (0, pad))


def _block_affine(params: dict, li: int, h):
    """gamma0/beta0 of block li: the feature LayerNorm's affine for the
    first block, ones/zeros for hidden blocks."""
    N, _, din = h.shape
    if li == 0:
        return _input_ln(params, din)
    return torch.ones((N, din), device=h.device), torch.zeros((N, din), device=h.device)


def _tower_operands(params: dict, h, layer_n: int):
    """(gamma0, beta0, ws, bs, gs, bes) for the tower, or None when the
    reference's gate refuses it (fused_mlp.py:703-721): B a multiple of 8
    (a row block of `_pick_tower_bm`; its FUSED_TOWER_BM block-size knob
    does not apply here), every layer H wide with H a multiple of 128, and
    the first Dense kernel, its rows padded to a multiple of 128, as wide
    as the padded input."""
    N, B, din0 = h.shape
    if B % 8:
        return None
    dense = [params[f"Dense_{li}"] for li in range(1 + layer_n)]
    ws = [_pad_rows(d["kernel"], d["kernel"].shape[1] + (-d["kernel"].shape[1]) % 128)
          for d in dense]
    H = ws[0].shape[-1]
    if H % 128 or ws[0].shape[1] != din0 or \
            any(tuple(w.shape[1:]) != (H, H) for w in ws[1:]):
        return None
    lns = [params[f"LayerNorm_{li + 1}"] for li in range(1 + layer_n)]
    g0, b0 = _input_ln(params, din0)
    return (g0, b0, ws, [d["bias"] for d in dense], [ln["scale"] for ln in lns],
            [ln["bias"] for ln in lns])


def mlp_base_stacked(params: dict, x, layer_n: int = 2, prenormed: bool = False):
    """Agent-stacked MLPBase forward on the fused kernels.

    params: the "MLPBase_0" subtree of MarlActor/MarlCritic parameters, every
    leaf with a leading agent axis N.  x: [N, B, obs_dim] f32, or the output
    of `feature_norm` when prenormed=True.  Returns [N, B, H] bf16.  The
    padded input columns meet zero rows of W and zero gamma0/beta0, so they
    contribute nothing, and their gradients are dropped with the pad.

    FUSED_TOWER=1 (read at each call, as the reference reads it) takes the
    whole tower, kernels B4/B5, wherever the reference's gate takes it
    (`_tower_operands`), with need_dx False: the x gradient is then None.
    Every other case runs one B2/B3 block per layer."""
    h = x if prenormed else feature_norm(x)
    if os.environ.get("FUSED_TOWER", "0") == "1":
        tower = _tower_operands(params, h, layer_n)
        if tower is not None:
            return mlp_tower(h, *tower)
    for li in range(1 + layer_n):
        dense, ln = params[f"Dense_{li}"], params[f"LayerNorm_{li + 1}"]
        g0, b0 = _block_affine(params, li, h)
        h = dense_elu_ln(h, _pad_rows(dense["kernel"], h.shape[-1]), dense["bias"],
                         ln["scale"], ln["bias"], g0, b0)
    return h


# ---------------------------------------------------------------------------
# parameter-directional tangent (HATRPO's Fisher-vector products)
# ---------------------------------------------------------------------------
#
# HATRPO's conjugate gradient needs Fisher-vector products F v = J^T M (J v)
# (Gauss-Newton).  J v is computed here in plain PyTorch from the
# activations of one forward on kernel B2, saved once per linearization
# point; J^T u is the autograd pullback through the kernels' backward.

def _ln_tangent(a, da, g, dg, dbe):
    """Directional tangent of y = LN(a)*g + beta given da, dg and dbeta."""
    mu, inv = _ln_stats(a.float())
    yhat = (a.float() - mu) * inv
    m1 = da.mean(-1, keepdim=True)
    m2 = (da * yhat).mean(-1, keepdim=True)
    dyhat = (da - m1 - yhat * m2) * inv
    return dyhat * g[:, None, :] + yhat * dg[:, None, :] + dbe[:, None, :]


def mlp_base_stacked_linearize(params: dict, x, layer_n: int = 2, prenormed: bool = False):
    """Forward on kernel B2 (whatever FUSED_TOWER says, as the reference's
    `_fwd_call`) and everything the parameter-directional tangent needs.

    Returns (h, saved); `saved` holds per layer the input stream x (bf16),
    the post-affine input xt (bf16), the activation a (bf16), the bf16
    Dense kernel w16, gamma0 and the LayerNorm scale, so HATRPO's repeated
    tangents at one point never re-run the forward."""
    h = x if prenormed else feature_norm(x)
    saved = []
    for li in range(1 + layer_n):
        dense, ln = params[f"Dense_{li}"], params[f"LayerNorm_{li + 1}"]
        g0, b0 = _block_affine(params, li, h)
        w16 = _pad_rows(dense["kernel"], h.shape[-1]).to(BF16)
        y, a = dense_elu_ln_fwd(h, w16, dense["bias"], ln["scale"], ln["bias"], g0, b0)
        saved.append(dict(x=h, xt=_input_affine(h, g0, b0), a=a, w16=w16, g0=g0,
                          scale=ln["scale"]))
        h = y
    return h, saved


def mlp_base_stacked_tangent(dparams: dict, saved, layer_n: int = 2):
    """Parameter-directional tangent dh [N, B, H] f32 from a saved
    linearization; the input's tangent is zero.  Per layer: dh_pre =
    bf16(dx_in) @ w16 + xt @ bf16(dW) + db (f32 products of bf16 values),
    with dx_in = x*dgamma0 + dbeta0 for the first layer and the previous
    layer's dh after; then the ELU and LayerNorm tangents."""
    dh = None
    for li in range(1 + layer_n):
        s = saved[li]
        dd, dln = dparams[f"Dense_{li}"], dparams[f"LayerNorm_{li + 1}"]
        din = s["x"].shape[-1]
        if li == 0:
            dg0, db0 = _input_ln(dparams, din)
            dxin = s["x"].float() * dg0[:, None, :] + db0[:, None, :]
        else:
            dxin = dh * s["g0"][:, None, :]
        dhp = torch.bmm(dxin.to(BF16).float(), s["w16"].float()) \
            + torch.bmm(s["xt"].float(), _pad_rows(dd["kernel"], din).to(BF16).float()) \
            + dd["bias"][:, None, :]
        af = s["a"].float()
        dh = _ln_tangent(s["a"], torch.where(af > 0, 1.0, af + 1.0) * dhp, s["scale"],
                         dln["scale"], dln["bias"])
    return dh


def mlp_base_stacked_jvp(params: dict, dparams: dict, x, layer_n: int = 2,
                         prenormed: bool = False):
    """(h, dh): linearize + one tangent (callers that take many tangents at
    one point keep the linearization)."""
    h, saved = mlp_base_stacked_linearize(params, x, layer_n=layer_n, prenormed=prenormed)
    return h, mlp_base_stacked_tangent(dparams, saved, layer_n=layer_n)
