"""Fused Dense -> ELU -> LayerNorm block, forward and backward, on the
hand-written kernels of csrc/fused_mlp.cu (counterpart of
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


def fwd_plain(x, w16, b, g, be, g0, b0):
    """(y, a), both [N, B, H] bf16.  Products of bf16 values are exact in
    f32, so the f32 bmm of the upcast operands is the f32-accumulated bf16
    product of the kernel (a bf16 bmm would round its output)."""
    xt = _input_affine(x, g0, b0)
    h = torch.bmm(xt.float(), w16.float()) + b[:, None, :]
    a = torch.where(h > 0, h, torch.exp(h) - 1.0)
    mu, inv = _ln_stats(a)
    y = (a - mu) * inv * g[:, None, :] + be[:, None, :]
    return y.to(BF16), a.to(BF16)


def bwd_plain(dy, a, x, w16, g, g0, b0):
    """(dx bf16, dW f32, db, dgamma, dbeta, dg0, db0 f32) from dy bf16."""
    dy = dy.float()
    a = a.float()
    xhat = x.float()
    xt = _input_affine(x, g0, b0)
    mu, inv = _ln_stats(a)
    yhat = (a - mu) * inv
    dyh = dy * g[:, None, :]
    m1 = dyh.mean(-1, keepdim=True)
    m2 = (dyh * yhat).mean(-1, keepdim=True)
    da = (dyh - m1 - yhat * m2) * inv
    dh = da * torch.where(a > 0, 1.0, a + 1.0)
    dh16 = dh.to(BF16)
    dx_raw = torch.bmm(dh16.float(), w16.float().transpose(1, 2))
    dx = (dx_raw * g0[:, None, :]).to(BF16)
    dw = torch.bmm(xt.float().transpose(1, 2), dh16.float())
    return (dx, dw, dh.sum(1), (dy * yhat).sum(1), dy.sum(1),
            (dx_raw * xhat).sum(1), dx_raw.sum(1))


# ---------------------------------------------------------------------------
# kernels (csrc/fused_mlp.cu)
# ---------------------------------------------------------------------------

class FusedMlpLib:
    """ctypes binding of csrc/fused_mlp.cu, built and loaded at first use."""

    def __init__(self):
        self.build_result = None
        self._lib = None

    def load(self):
        if self._lib is None:
            res = _build.build("fused_mlp.cu")
            lib = ctypes.CDLL(res.path)
            p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
            lib.dense_elu_ln_fwd.argtypes = [i, i, i, i, ll] + [p] * 9 + [p]
            lib.dense_elu_ln_fwd.restype = i
            lib.dense_elu_ln_bwd_scratch.argtypes = [i, i, i, i]
            lib.dense_elu_ln_bwd_scratch.restype = ll
            lib.dense_elu_ln_bwd.argtypes = [i, i, i, i, ll] + [p] * 14 + [p, p]
            lib.dense_elu_ln_bwd.restype = i
            self._lib, self.build_result = lib, res
        return self._lib


fused_mlp_lib = FusedMlpLib()


def _check(name, t, shape, dtype, dev):
    if t.device != dev or t.dtype != dtype or tuple(t.shape) != tuple(shape) \
            or not t.is_contiguous():
        raise ValueError(f"dense_elu_ln kernel: {name} must be a contiguous {dtype} "
                         f"{tuple(shape)} tensor on {dev}, got {t.dtype} "
                         f"{tuple(t.shape)} (contiguous={t.is_contiguous()}) on {t.device}")


def _check_x(x, N, B, Din, dev):
    """x [N, B, Din] bf16, rows contiguous; the agent stride is B*Din or 0."""
    if x.device != dev or x.dtype != BF16 or tuple(x.shape) != (N, B, Din) \
            or x.stride(2) != 1 or x.stride(1) != Din or x.stride(0) not in (0, B * Din):
        raise ValueError(f"dense_elu_ln kernel: x must be a bf16 ({N}, {B}, {Din}) tensor "
                         f"on {dev} with rows contiguous, got {x.dtype} {tuple(x.shape)} "
                         f"strides {x.stride()} on {x.device}")
    return x.stride(0)


def _check_dims(Din, H):
    if Din % 128 or H not in (128, 256, 384, 512):
        raise ValueError(f"dense_elu_ln kernel takes Din a multiple of 128 and H in "
                         f"(128, 256, 384, 512), got Din={Din}, H={H}")


class DenseEluLnFwdKernel:
    """Kernel B2.  `launches` counts kernel launches and nothing else."""

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
            dw.data_ptr(), vec_h[0].data_ptr(), vec_h[1].data_ptr(), vec_h[2].data_ptr(),
            vec_d[0].data_ptr(), vec_d[1].data_ptr(), scratch.data_ptr(), stream)
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


def mlp_base_stacked(params: dict, x, layer_n: int = 2, prenormed: bool = False):
    """Agent-stacked MLPBase forward on the fused block.

    params: the "MLPBase_0" subtree of MarlActor/MarlCritic parameters, every
    leaf with a leading agent axis N.  x: [N, B, obs_dim] f32, or the output
    of `feature_norm` when prenormed=True.  Returns [N, B, H] bf16.  The
    padded input columns meet zero rows of W and zero gamma0/beta0, so they
    contribute nothing, and their gradients are dropped with the pad."""
    if os.environ.get("FUSED_TOWER", "0") == "1":
        raise NotImplementedError(
            "FUSED_TOWER=1 selects the whole-tower kernels B4/B5, which are not "
            "ported yet (ROADMAP B.3)")
    h = x if prenormed else feature_norm(x)
    N = h.shape[0]
    for li in range(1 + layer_n):
        dense, ln = params[f"Dense_{li}"], params[f"LayerNorm_{li + 1}"]
        din = h.shape[-1]
        if li == 0:     # the feature LayerNorm's affine, padded with zeros
            ln0 = params["LayerNorm_0"]
            pad = din - ln0["scale"].shape[-1]
            g0, b0 = F.pad(ln0["scale"], (0, pad)), F.pad(ln0["bias"], (0, pad))
        else:
            g0 = torch.ones((N, din), device=h.device)
            b0 = torch.zeros((N, din), device=h.device)
        h = dense_elu_ln(h, _pad_rows(dense["kernel"], din), dense["bias"], ln["scale"],
                         ln["bias"], g0, b0)
    return h
