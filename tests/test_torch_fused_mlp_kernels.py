"""The dense_elu_ln kernels' wrappers (B2 forward, B3 backward) and their
device rule.

CPU tests: a CPU tensor takes the plain version and never touches the
launch counters; the kernel wrappers refuse CPU tensors; DenseEluLN's
backward is the plain backward, and so is the FUSED_TOWER branch's
(tests/test_torch_fused_tower.py has the tower's own tests).

Tests marked `cuda` hold the kernels against their plain versions on the
card (ragged row counts, every hidden width the kernels take, a shared
input with agent stride 0, dx skipped, the same bits twice), and a whole tower's gradients
through DenseEluLN against the same tower on the CPU's plain versions;
they skip without a card.  They import
nothing of JAX, so on the GPU host they run without the repository's JAX
conftest:
    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_fused_mlp_kernels.py -m cuda
Tolerances on the card: bf16 outputs within one bf16 ulp (relative 2^-7)
plus 1e-3 of their scale, because the product's f32 summation order differs
and flips a few roundings; f32 sums within 1e-3 relative plus 1e-4 of
their scale (summation order over up to B rows).
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from massive_marl_tpu_torch.ops import fused_mlp as fm

BF16 = torch.bfloat16


def _inputs(N, B, Din, H, device, seed=0, shared=False):
    g = torch.Generator().manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=g)
    x = fm.feature_norm(r(1 if shared else N, B, Din - 6))
    x = x.expand(N, B, Din) if shared else x
    vals = dict(w16=(r(N, Din, H) * (2.0 / Din) ** 0.5).to(BF16), b=0.1 * r(N, H),
                g=1 + 0.1 * r(N, H), be=0.1 * r(N, H), g0=1 + 0.1 * r(N, Din),
                b0=0.1 * r(N, Din), dy=r(N, B, H).to(BF16))
    out = {k: v.to(device) for k, v in vals.items()}
    out["x"] = x.to(device)
    return out


def _fwd_args(d):
    return d["x"], d["w16"], d["b"], d["g"], d["be"], d["g0"], d["b0"]


def test_cpu_tensors_take_the_plain_version():
    d = _inputs(2, 20, 128, 128, "cpu")
    nf, nb = fm.fwd_kernel.launches, fm.bwd_kernel.launches
    y, a = fm.dense_elu_ln_fwd(*_fwd_args(d))
    out = fm.dense_elu_ln_bwd(d["dy"], a, d["x"], d["w16"], d["g"], d["g0"], d["b0"],
                              need_dx=False)
    assert (fm.fwd_kernel.launches, fm.bwd_kernel.launches) == (nf, nb)
    assert y.dtype == a.dtype == BF16 and tuple(y.shape) == (2, 20, 128)
    assert out[0] is None and [tuple(t.shape) for t in out[1:]] == \
        [(2, 128, 128), (2, 128), (2, 128), (2, 128), (2, 128), (2, 128)]
    ref = fm.bwd_plain(d["dy"], a, d["x"], d["w16"], d["g"], d["g0"], d["b0"])
    for got, want in zip(out[1:], ref[1:]):
        assert torch.equal(got, want)
    with pytest.raises(ValueError, match="CUDA"):
        fm.fwd_kernel(*_fwd_args(d))
    with pytest.raises(ValueError, match="CUDA"):
        fm.bwd_kernel(d["dy"], a, d["x"], d["w16"], d["g"], d["g0"], d["b0"])


def test_autograd_function_uses_the_plain_backward():
    d = _inputs(2, 24, 128, 128, "cpu", seed=1)
    w = d["w16"].float().requires_grad_()
    params = [d[k].clone().requires_grad_() for k in ("b", "g", "be", "g0", "b0")]
    y = fm.dense_elu_ln(d["x"], w, *params)
    grads = torch.autograd.grad((y.float() * d["dy"].float()).sum(), [w] + params)
    _, a = fm.fwd_plain(*_fwd_args(d))
    ref = fm.bwd_plain(d["dy"], a, d["x"], d["w16"], d["g"], d["g0"], d["b0"])
    for got, want in zip(grads, ref[1:]):
        assert torch.equal(got, want)


def test_fused_tower_branch_uses_the_plain_tower_backward(monkeypatch):
    """FUSED_TOWER=1: mlp_base_stacked's gradients are MlpTower's, that is
    tower_bwd_plain's on CPU tensors, bit for bit; the x gradient is None."""
    monkeypatch.setenv("FUSED_TOWER", "1")
    g = torch.Generator().manual_seed(4)
    r = lambda *s: torch.randn(*s, generator=g)
    N, B, H = 2, 16, 128
    params = {"LayerNorm_0": {"scale": 1 + 0.1 * r(N, 46), "bias": 0.1 * r(N, 46)}}
    for i in range(3):
        params[f"Dense_{i}"] = {"kernel": 0.1 * r(N, 46 if i == 0 else H, H), "bias": 0.1 * r(N, H)}
        params[f"LayerNorm_{i + 1}"] = {"scale": 1 + 0.1 * r(N, H), "bias": 0.1 * r(N, H)}
    x, dy = fm.feature_norm(r(N, B, 46)).requires_grad_(), r(N, B, H).to(BF16)
    leaves = [t.requires_grad_() for d in params.values() for t in d.values()]
    y = fm.mlp_base_stacked(params, x, prenormed=True)
    grads = torch.autograd.grad((y.float() * dy.float()).sum(), [x] + leaves, allow_unused=True)
    assert grads[0] is None
    got = dict(zip([(a, b) for a, d in params.items() for b in d], grads[1:]))
    ws16 = [F.pad(params[f"Dense_{i}"]["kernel"], (0, 0, 0, 82 if i == 0 else 0)).to(BF16)
            for i in range(3)]
    g0, b0 = (F.pad(params["LayerNorm_0"][k], (0, 82)) for k in ("scale", "bias"))
    _, dws, dbs, dgs, dbes, dg0, db0 = fm.tower_bwd_plain(
        dy, x, g0, b0, ws16, [params[f"Dense_{i}"]["bias"] for i in range(3)],
        [params[f"LayerNorm_{i + 1}"]["scale"] for i in range(3)],
        [params[f"LayerNorm_{i + 1}"]["bias"] for i in range(3)])
    assert torch.equal(got[("LayerNorm_0", "scale")], dg0[:, :46])
    assert torch.equal(got[("LayerNorm_0", "bias")], db0[:, :46])
    for i in range(3):
        assert torch.equal(got[(f"Dense_{i}", "kernel")], dws[i][:, :46 if i == 0 else H])
        assert torch.equal(got[(f"Dense_{i}", "bias")], dbs[i])
        assert torch.equal(got[(f"LayerNorm_{i + 1}", "scale")], dgs[i])
        assert torch.equal(got[(f"LayerNorm_{i + 1}", "bias")], dbes[i])


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _close(got, ref, bf16, name):
    got, ref = got.float().cpu().numpy(), ref.float().cpu().numpy()
    scale = float(np.abs(ref).max())
    rtol, atol = (2.0 ** -7, 1e-3 * scale) if bf16 else (1e-3, 1e-4 * scale)
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=atol, err_msg=name)


# ragged B (1, 63, 65, 4,096 + 37), every H, Din 128, 384, 512 and 1024,
# N = 10 with a shared input; the dW pass's row split is 1 at B <= 256 and
# more than 1 at (1, 4097, 512, 512) and (1, 4133, 512, 256).  B2 runs in
# clusters of two 64-row blocks of one agent: at (3, 130, ...) each agent
# has three blocks, so the second block of a cluster's last item lies past
# the agent's rows.  The f32 sums'
# 1e-4 of their scale holds where one dh16 rounding the other way (the row
# statistics are summed in another order than torch's mean) stays inside
# it: at N = 10 the case takes B = 4,133, not 65
@pytest.mark.cuda
@pytest.mark.parametrize("N,B,Din,H,shared", [(2, 100, 128, 128, False), (3, 200, 256, 384, True),
                                              (1, 4097, 512, 512, False),
                                              (2, 64, 384, 256, True), (1, 1, 128, 128, False),
                                              (1, 63, 128, 512, False), (10, 4133, 512, 384, True),
                                              (1, 4133, 512, 256, False),
                                              (2, 65, 384, 128, False),
                                              (3, 130, 128, 512, True),
                                              (1, 300, 1024, 256, False)])
def test_kernels_match_plain_on_card(cuda, N, B, Din, H, shared):
    d = _inputs(N, B, Din, H, cuda, seed=2, shared=shared)
    nf, nb = fm.fwd_kernel.launches, fm.bwd_kernel.launches
    y, a = fm.dense_elu_ln_fwd(*_fwd_args(d))
    out = fm.dense_elu_ln_bwd(d["dy"], a, d["x"], d["w16"], d["g"], d["g0"], d["b0"])
    torch.cuda.synchronize()
    assert (fm.fwd_kernel.launches, fm.bwd_kernel.launches) == (nf + 1, nb + 1)
    yp, ap = fm.fwd_plain(*_fwd_args(d))
    _close(y, yp, True, "y")
    _close(a, ap, True, "a")
    ref = fm.bwd_plain(d["dy"], a, d["x"], d["w16"], d["g"], d["g0"], d["b0"])
    for name, got, want in zip(["dx", "dw", "db", "dgamma", "dbeta", "dg0", "db0"], out, ref):
        _close(got, want, name == "dx", name)
    no_dx = fm.dense_elu_ln_bwd(d["dy"], a, d["x"], d["w16"], d["g"], d["g0"], d["b0"],
                                need_dx=False)
    assert no_dx[0] is None
    for got, want in zip(no_dx[1:], out[1:]):  # fixed-order sums: the same bits
        assert torch.equal(got, want)
    again = fm.dense_elu_ln_bwd(d["dy"], a, d["x"], d["w16"], d["g"], d["g0"], d["b0"])
    for got, want in zip(again, out):   # dx too
        assert torch.equal(got, want)


@pytest.mark.cuda
def test_kernels_reject_bad_operands(cuda):
    d = _inputs(2, 64, 128, 128, cuda)
    with pytest.raises(ValueError, match="gamma"):
        fm.fwd_kernel(d["x"], d["w16"], d["b"], d["g"][:, :64], d["be"], d["g0"], d["b0"])
    with pytest.raises(ValueError, match="x must be"):
        fm.fwd_kernel(d["x"].transpose(1, 2), d["w16"], d["b"], d["g"], d["be"], d["g0"],
                      d["b0"])
    w = d["w16"][:, :, :96].contiguous()
    with pytest.raises(ValueError, match="H in"):
        fm.fwd_kernel(d["x"], w, d["b"][:, :96], d["g"][:, :96], d["be"][:, :96], d["g0"],
                      d["b0"])
    g0 = torch.empty(d["g0"].numel() + 1, device=d["g0"].device)[1:].view(d["g0"].shape)
    g0.copy_(d["g0"])  # contiguous, 4 bytes past an aligned address
    with pytest.raises(ValueError, match="16-byte-aligned"):
        fm.fwd_kernel(d["x"], d["w16"], d["b"], d["g"], d["be"], g0, d["b0"])


@pytest.mark.cuda
def test_tower_grads_through_kernels_match_plain(cuda):
    """mlp_base_stacked (3 blocks, padded obs 46 -> 128, hidden 256) on the
    card: one B2 launch per block forward and one B3 launch per block
    backward; gradients of every parameter within 6e-2 of their scale of
    the CPU plain path, the tower-gradient tolerance of
    tests/test_fused_mlp.py:38-62 (the one-ulp bf16 flips of each block
    feed the next)."""
    g = torch.Generator().manual_seed(3)
    r = lambda *s: torch.randn(*s, generator=g)
    N, B, H = 2, 300, 256
    params = {"LayerNorm_0": {"scale": 1 + 0.1 * r(N, 46), "bias": 0.1 * r(N, 46)}}
    din = 46
    for i in range(3):
        params[f"Dense_{i}"] = {"kernel": r(N, din, H) * (2.0 / din) ** 0.5,
                                "bias": 0.1 * r(N, H)}
        params[f"LayerNorm_{i + 1}"] = {"scale": 1 + 0.1 * r(N, H), "bias": 0.1 * r(N, H)}
        din = H
    x, c = r(N, B, 46), r(N, B, H)
    grads = {}
    for dev in ("cpu", cuda):
        leaves = {(a, b): t.detach().clone().to(dev).requires_grad_()
                  for a, d in params.items() for b, t in d.items()}
        tree = {a: {b: leaves[(a, b)] for b in d} for a, d in params.items()}
        nf, nb = fm.fwd_kernel.launches, fm.bwd_kernel.launches
        y = fm.mlp_base_stacked(tree, x.to(dev))
        out = torch.autograd.grad((y.float() * c.to(dev)).sum(), list(leaves.values()))
        if dev != "cpu":
            torch.cuda.synchronize()
            assert (fm.fwd_kernel.launches - nf, fm.bwd_kernel.launches - nb) == (3, 3)
        grads[str(dev)] = dict(zip(leaves, (o.cpu() for o in out)))
    for key, ref in grads["cpu"].items():
        got = grads[str(torch.device(cuda))][key].numpy()
        ref = ref.numpy()
        np.testing.assert_allclose(got, ref, rtol=0, atol=6e-2 * np.abs(ref).max(),
                                   err_msg="/".join(key))
