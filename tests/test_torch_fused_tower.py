"""The whole-tower path (kernels B4/B5, `MlpTower`, the FUSED_TOWER branch of
`mlp_base_stacked`) against the JAX package and against itself.

CPU tests, at the shape of tests/test_fused_mlp.py's tower tests (n 2, b 64,
Din 128, H 128, L 3), inputs made with numpy from a seed:
  * the port's plain tower against `mlp_tower(..., interpret=True)` of the
    JAX package (one JAX run per case, in a module-scoped fixture): y within
    one bf16 ulp (relative 2^-7) plus 1e-3 of its scale, because both round
    the same f32 values and only the f32 summation order differs; every
    gradient, need_dx False and True, within 5e-2 of each leaf's scale
    (max(1, max |ref|)), the tolerance of tests/test_fused_mlp.py:168-212;
  * the tower's forward equals the per-layer plain chain bit for bit;
  * the gate of `mlp_base_stacked` under FUSED_TOWER=1;
  * CPU tensors never move the launch counters; the kernel wrappers refuse
    them.

Tests marked `cuda` hold B4/B5 against their plain versions on the card
(ragged B, every H the kernels take, a shared input with agent stride 0,
one and three layers, dx both ways, the same bits from run to run).  JAX is imported only inside
the fixture that needs it, so on the GPU host they run without it:
    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_fused_tower.py
Tolerances on the card, TOWER_TOL of the output's scale, looser than
B2/B3's because each layer's one-ulp flips feed the layers after it (y)
and, through the f32 cotangent, the layers below (B5).  The plain version
alone, run on the CPU with float64 instead of float32 products (another
summation order, nothing else), moves y by up to 1.1e-3 of its scale
beyond one bf16 ulp, dx by 4.7e-3, dW by 1.0e-3 and db, dgamma, dbeta,
dg0, db0 by 6e-4 at these shapes; the tolerances are two to three times
that (y: one ulp, relative 2^-7, plus TOWER_TOL["y"]).
"""
import numpy as np
import pytest
import torch

from massive_marl_tpu_torch.ops import fused_mlp as fm

BF16 = torch.bfloat16
TOWER_TOL = {"y": 3e-3, "dx": 1e-2, "sum": 3e-3}   # of the output's scale, on the card
N, B, DIN, H, L = 2, 64, 128, 128, 3


def _np_inputs(seed, n, b, din, h, layers, shared=False):
    rng = np.random.default_rng(seed)
    f = lambda *s, scale=1.0, off=0.0: (off + scale * rng.normal(size=s)).astype(np.float32)
    return dict(x=f(1 if shared else n, b, din - 6), g0=f(n, din, scale=0.1, off=1.0),
                b0=f(n, din, scale=0.1),
                w=[f(n, din if li == 0 else h, h, scale=0.1) for li in range(layers)],
                b=[f(n, h, scale=0.1) for _ in range(layers)],
                g=[f(n, h, scale=0.1, off=1.0) for _ in range(layers)],
                be=[f(n, h, scale=0.1) for _ in range(layers)],
                c=f(n, b, h))


def _port(d, device="cpu", shared=False):
    """Torch operands: x = feature_norm of the raw features (bf16), the
    vectors and f32 master weights, and the cotangent c (f32)."""
    t = lambda a: torch.from_numpy(a).to(device)
    x = fm.feature_norm(t(d["x"]))
    if shared:
        x = x.expand(d["g0"].shape[0], *x.shape[1:])
    return dict(x=x, g0=t(d["g0"]), b0=t(d["b0"]), w=[t(w) for w in d["w"]],
                b=[t(v) for v in d["b"]], g=[t(v) for v in d["g"]],
                be=[t(v) for v in d["be"]], c=t(d["c"]))


def _leaves(p):
    return [p["g0"], p["b0"], *p["w"], *p["b"], *p["g"], *p["be"]]


def _port_grads(p, need_dx):
    """The gradients of sum(y * c) through MlpTower: [dx, dg0, db0, dWs...,
    dbs..., dgammas..., dbetas...]."""
    x = p["x"].detach().clone().requires_grad_()
    leaves = [t.clone().requires_grad_() for t in _leaves(p)]
    g0, b0, rest = leaves[0], leaves[1], leaves[2:]
    y = fm.mlp_tower(x, g0, b0, rest[:L], rest[L:2 * L], rest[2 * L:3 * L], rest[3 * L:],
                     need_dx=need_dx)
    grads = torch.autograd.grad((y.float() * p["c"]).sum(), [x] + leaves, allow_unused=True)
    return list(grads)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_tower():
    """The JAX package's tower on the same inputs, in interpret mode: y and
    the gradients of sum(y * c) for need_dx False and True."""
    import jax
    import jax.numpy as jnp

    from massive_marl_tpu.ops import fused_mlp as j_fm
    d = _np_inputs(0, N, B, DIN, H, L)
    x = j_fm.feature_norm(jnp.asarray(d["x"]))
    args = (jnp.asarray(d["g0"]), jnp.asarray(d["b0"])) + tuple(
        tuple(jnp.asarray(a) for a in d[k]) for k in ("w", "b", "g", "be"))

    def tower(xx, a, need_dx):
        return j_fm.mlp_tower(xx, *a, 32, True, need_dx)

    out = {"y": np.asarray(tower(x, args, False).astype(jnp.float32))}
    for need_dx in (False, True):
        loss = lambda xx, a: (tower(xx, a, need_dx).astype(jnp.float32) * d["c"]).sum()
        gx, ga = jax.grad(loss, argnums=(0, 1))(x, args)
        flat = [ga[0], ga[1], *ga[2], *ga[3], *ga[4], *ga[5]]
        out[need_dx] = [np.asarray(gx.astype(jnp.float32))] + [np.asarray(g) for g in flat]
    return d, out


def _leaf_names():
    return ["x", "g0", "b0"] + [f"{k}[{li}]" for k in ("w", "b", "g", "be") for li in range(L)]


def test_plain_tower_forward_matches_pallas(jax_tower):
    d, ref = jax_tower
    p = _port(d)
    y = fm.tower_fwd_plain(p["x"], p["g0"], p["b0"], [w.to(BF16) for w in p["w"]], p["b"],
                           p["g"], p["be"])
    np.testing.assert_allclose(y.float().numpy(), ref["y"], rtol=2.0 ** -7,
                               atol=1e-3 * np.abs(ref["y"]).max())


@pytest.mark.parametrize("need_dx", [False, True])
def test_plain_tower_grads_match_pallas(jax_tower, need_dx):
    d, ref = jax_tower
    got = _port_grads(_port(d), need_dx)
    for name, g, r in zip(_leaf_names(), got, ref[need_dx]):
        if name == "x" and not need_dx:
            assert g is None and not r.any()     # JAX returns zeros, the port None
            continue
        np.testing.assert_allclose(g.float().numpy(), r, rtol=0,
                                   atol=5e-2 * max(1.0, float(np.abs(r).max())), err_msg=name)


def test_tower_forward_equals_per_layer_chain():
    p = _port(_np_inputs(1, N, B, DIN, H, L))
    ws16 = [w.to(BF16) for w in p["w"]]
    y = fm.tower_fwd_plain(p["x"], p["g0"], p["b0"], ws16, p["b"], p["g"], p["be"])
    h = p["x"]
    for li in range(L):
        g0, b0 = (p["g0"], p["b0"]) if li == 0 else (torch.ones(N, H), torch.zeros(N, H))
        h, _ = fm.fwd_plain(h, ws16[li], p["b"][li], p["g"][li], p["be"][li], g0, b0)
    assert torch.equal(y, h)
    # the backward recomputes the same forward, so the last layer's
    # gradients (bf16 dy in) are bwd_plain's on that layer's input, exactly
    dy = p["c"].to(BF16)
    out = fm.tower_bwd_plain(dy, p["x"], p["g0"], p["b0"], ws16, p["b"], p["g"], p["be"])
    x_last = fm.tower_fwd_plain(p["x"], p["g0"], p["b0"], ws16[:-1], p["b"][:-1], p["g"][:-1],
                                p["be"][:-1])
    one, zero = torch.ones(N, H), torch.zeros(N, H)
    _, a = fm.fwd_plain(x_last, ws16[-1], p["b"][-1], p["g"][-1], p["be"][-1], one, zero)
    last = fm.bwd_plain(dy, a, x_last, ws16[-1], p["g"][-1], one, zero)
    for got, want in zip((out[1][-1], out[2][-1], out[3][-1], out[4][-1]), last[1:5]):
        assert torch.equal(got, want)


def _mlp_params(seed, n, obs, h, layers=3):
    rng = np.random.default_rng(seed)
    f = lambda *s, scale=1.0, off=0.0: torch.from_numpy(
        (off + scale * rng.normal(size=s)).astype(np.float32))
    p = {"LayerNorm_0": {"scale": f(n, obs, scale=0.1, off=1.0), "bias": f(n, obs, scale=0.1)}}
    din = obs
    for li in range(layers):
        p[f"Dense_{li}"] = {"kernel": f(n, din, h, scale=(2.0 / din) ** 0.5),
                            "bias": f(n, h, scale=0.1)}
        p[f"LayerNorm_{li + 1}"] = {"scale": f(n, h, scale=0.1, off=1.0),
                                    "bias": f(n, h, scale=0.1)}
        din = h
    return p


@pytest.mark.parametrize("rows,hidden,tower", [(64, 128, True), (60, 128, False),
                                               (64, 96, False)])
def test_mlp_base_stacked_gate(monkeypatch, rows, hidden, tower):
    """FUSED_TOWER=1 takes the tower where the reference's gate does (B a
    multiple of 8, H a multiple of 128) and the per-layer blocks elsewhere;
    the forward is the same bits either way."""
    params = _mlp_params(2, N, 46, hidden)
    x = torch.from_numpy(np.random.default_rng(3).normal(size=(N, rows, 46)).astype(np.float32))
    calls = {"tower": 0, "block": 0}
    real_tower, real_block = fm.tower_fwd_plain, fm.fwd_plain

    def count(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped
    monkeypatch.setattr(fm, "tower_fwd_plain", count("tower", real_tower))
    monkeypatch.setattr(fm, "fwd_plain", count("block", real_block))
    monkeypatch.setenv("FUSED_TOWER", "0")
    y0 = fm.mlp_base_stacked(params, x)
    assert calls == {"tower": 0, "block": 3}
    monkeypatch.setenv("FUSED_TOWER", "1")
    y1 = fm.mlp_base_stacked(params, x)
    assert calls == ({"tower": 1, "block": 3} if tower else {"tower": 0, "block": 6})
    assert torch.equal(y0, y1)


def test_cpu_tensors_keep_the_counters_and_kernels_refuse_them(jax_tower):
    d, _ = jax_tower
    p = _port(d)
    ws16 = [w.to(BF16) for w in p["w"]]
    args = (p["x"], p["g0"], p["b0"], ws16, p["b"], p["g"], p["be"])
    nf, nb = fm.tower_fwd_kernel.launches, fm.tower_bwd_kernel.launches
    y = fm.mlp_tower_fwd(*args)
    out = fm.mlp_tower_bwd(p["c"].to(BF16), *args, need_dx=False)
    _port_grads(p, need_dx=True)
    assert (fm.tower_fwd_kernel.launches, fm.tower_bwd_kernel.launches) == (nf, nb)
    assert y.dtype == BF16 and tuple(y.shape) == (N, B, H) and out[0] is None
    with pytest.raises(ValueError, match="CUDA"):
        fm.tower_fwd_kernel(*args)
    with pytest.raises(ValueError, match="CUDA"):
        fm.tower_bwd_kernel(p["c"].to(BF16), *args)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _close(got, ref, kind, name):
    got, ref = got.float().cpu().numpy(), ref.float().cpu().numpy()
    scale = float(np.abs(ref).max())
    rtol = 2.0 ** -7 if kind == "y" else 0.0
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=TOWER_TOL[kind] * scale, err_msg=name)


# ragged B (1, 63, 65, 4,096 + 37), every H, Din 128 and 512, N = 10 with a
# shared input, L = 1 and 3; the dW pass's row split is 1 at B <= 256 and
# more than 1 at (1, 4133, 512, 384) and (1, 4097, 512, 384).  B4 runs in
# clusters of two 64-row blocks of one agent: at (3, 130, ...) each agent
# has three blocks, so a cluster's last item runs past the agent's rows
@pytest.mark.cuda
@pytest.mark.parametrize("n,b,din,h,shared,layers", [
    (2, 100, 128, 128, False, L), (3, 200, 256, 256, True, L), (1, 4097, 512, 384, False, L),
    (2, 1000, 128, 512, False, L), (10, 640, 512, 512, True, L), (1, 1, 128, 128, False, 1),
    (1, 63, 512, 256, False, 3), (10, 65, 512, 512, True, 1), (1, 4133, 512, 384, False, 3),
    (2, 4133, 128, 128, False, 1), (3, 130, 512, 512, True, 3)])
def test_tower_kernels_match_plain_on_card(cuda, n, b, din, h, shared, layers):
    p = _port(_np_inputs(4, n, b, din, h, layers, shared), cuda, shared)
    ws16 = [w.to(BF16) for w in p["w"]]
    args = (p["x"], p["g0"], p["b0"], ws16, p["b"], p["g"], p["be"])
    dy = p["c"].to(BF16)
    nf, nb = fm.tower_fwd_kernel.launches, fm.tower_bwd_kernel.launches
    y = fm.mlp_tower_fwd(*args)
    out = fm.mlp_tower_bwd(dy, *args, need_dx=True)
    torch.cuda.synchronize()
    assert (fm.tower_fwd_kernel.launches, fm.tower_bwd_kernel.launches) == (nf + 1, nb + 1)
    _close(y, fm.tower_fwd_plain(*args), "y", "y")
    ref = fm.tower_bwd_plain(dy, *args, need_dx=True)
    _close(out[0], ref[0], "dx", "dx")
    for name, got_l, ref_l in zip(("dW", "db", "dgamma", "dbeta"), out[1:5], ref[1:5]):
        for li, (got, want) in enumerate(zip(got_l, ref_l)):
            _close(got, want, "sum", f"{name}[{li}]")
    _close(out[5], ref[5], "sum", "dg0")
    _close(out[6], ref[6], "sum", "db0")
    again = fm.mlp_tower_bwd(dy, *args, need_dx=False)   # fixed-order sums: the same bits
    assert again[0] is None
    for got, want in zip([*again[1], *again[2], *again[3], *again[4], again[5], again[6]],
                         [*out[1], *out[2], *out[3], *out[4], out[5], out[6]]):
        assert torch.equal(got, want)


@pytest.mark.cuda
def test_tower_kernels_reject_bad_operands(cuda):
    p = _port(_np_inputs(5, 2, 64, 640, 128, 2), cuda)
    ws16 = [w.to(BF16) for w in p["w"]]
    with pytest.raises(ValueError, match="up to 512"):
        fm.tower_fwd_kernel(p["x"], p["g0"], p["b0"], ws16, p["b"], p["g"], p["be"])
    p = _port(_np_inputs(5, 2, 64, 128, 128, 2), cuda)
    ws16 = [w.to(BF16) for w in p["w"]]
    with pytest.raises(ValueError, match="gamma"):
        fm.tower_fwd_kernel(p["x"], p["g0"], p["b0"], ws16, p["b"], [p["g"][0][:, :64]] * 2,
                            p["be"])
    b0 = torch.empty(p["b0"].numel() + 1, device=p["b0"].device)[1:].view(p["b0"].shape)
    b0.copy_(p["b0"])  # contiguous, 4 bytes past an aligned address
    with pytest.raises(ValueError, match="16-byte-aligned"):
        fm.tower_fwd_kernel(p["x"], p["g0"], b0, ws16, p["b"], p["g"], p["be"])


@pytest.mark.cuda
def test_fused_tower_grads_on_card_match_plain(cuda, monkeypatch):
    """mlp_base_stacked under FUSED_TOWER=1 (obs 46 padded to 128, hidden
    256) on the card: one B4 and one B5 launch, no B2/B3, and every
    parameter's gradient within 1e-2 of its scale of the CPU plain tower
    (the one-ulp flips of dh16 feed through the f32 chain)."""
    monkeypatch.setenv("FUSED_TOWER", "1")
    params = _mlp_params(6, 2, 46, 256)
    x = torch.from_numpy(np.random.default_rng(7).normal(size=(2, 304, 46)).astype(np.float32))
    c = torch.from_numpy(np.random.default_rng(8).normal(size=(2, 304, 256)).astype(np.float32))
    grads = {}
    for dev in ("cpu", cuda):
        leaves = {(a, b): t.clone().to(dev).requires_grad_()
                  for a, dd in params.items() for b, t in dd.items()}
        tree = {a: {b: leaves[(a, b)] for b in dd} for a, dd in params.items()}
        before = (fm.tower_fwd_kernel.launches, fm.tower_bwd_kernel.launches,
                  fm.fwd_kernel.launches, fm.bwd_kernel.launches)
        y = fm.mlp_base_stacked(tree, x.to(dev))
        out = torch.autograd.grad((y.float() * c.to(dev)).sum(), list(leaves.values()))
        if dev != "cpu":
            torch.cuda.synchronize()
            after = (fm.tower_fwd_kernel.launches, fm.tower_bwd_kernel.launches,
                     fm.fwd_kernel.launches, fm.bwd_kernel.launches)
            assert tuple(a - b for a, b in zip(after, before)) == (1, 1, 0, 0)
        grads[str(dev)] = dict(zip(leaves, (o.cpu() for o in out)))
    for key, ref in grads["cpu"].items():
        got = grads[str(torch.device(cuda))][key].numpy()
        np.testing.assert_allclose(got, ref.numpy(), rtol=0, atol=1e-2 * np.abs(ref.numpy()).max(),
                                   err_msg="/".join(key))
