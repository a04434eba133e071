"""Port parity of the layer norm: the plain versions of K3/K4
(``apex_tpu_torch.ops.layer_norm``), their autograd Function and the
``FusedLayerNorm`` module against the JAX package's Pallas kernel
(``layer_norm_pallas.layer_norm`` in interpret mode, and its
``jax.vjp``) and its ``FusedLayerNorm`` module, on the same numpy inputs.

Tolerances: fp32 1e-5 (the same fp32 ops, sums in another order); the
fp32 affine gradients 1e-5 relative to their scale (sums over all rows);
bf16 outputs 2e-2 (one bf16 ulp of values up to ~4, the band of
tests/test_layer_norm_pallas.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.normalization.fused_layer_norm import (
    FusedLayerNorm as JFusedLayerNorm,
    fused_layer_norm as jfused_layer_norm,
)
from apex_tpu.ops import layer_norm_pallas as lnp
from apex_tpu_torch.normalization import FusedLayerNorm, fused_layer_norm
from apex_tpu_torch.ops import layer_norm as tln
from apex_tpu_torch.ops import layer_norm_cuda as lnc

DTYPES = {"float32": (jnp.float32, torch.float32, 1e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _inputs(seed, rows, hidden, affine):
    rs = np.random.RandomState(seed)
    x = (rs.randn(rows, hidden) * 2 + 1).astype(np.float32)
    w = (rs.rand(hidden) + 0.5).astype(np.float32) if affine else None
    b = rs.randn(hidden).astype(np.float32) if affine else None
    dy = rs.randn(rows, hidden).astype(np.float32)
    return x, w, b, dy


def _j(a, dtype=jnp.float32):
    return None if a is None else jnp.asarray(a, dtype)


def _t(a, dtype=torch.float32):
    return None if a is None else torch.from_numpy(a).to(dtype)


def _close(got, want, tol, scale=False):
    if isinstance(got, torch.Tensor):
        got = got.detach().float().numpy()
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    atol = tol * max(1.0, np.abs(want).max()) if scale else tol
    np.testing.assert_allclose(got, want, atol=atol, rtol=0)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("affine", [True, False])
@pytest.mark.parametrize("rows,hidden", [(64, 128), (32, 768)])
def test_plain_fwd_bwd_match_the_pallas_kernel(dtype, affine, rows, hidden):
    jdt, tdt, tol = DTYPES[dtype]
    x, w, b, dy = _inputs(0, rows, hidden, affine)
    assert lnp.supported(rows, hidden)
    jy, res = lnp._fwd(_j(x, jdt), _j(w), _j(b), 1e-5, True)
    _, vjp = jax.vjp(lambda x_, w_, b_: lnp.layer_norm(x_, w_, b_, 1e-5,
                                                        True),
                     _j(x, jdt), _j(w), _j(b))
    jdx, jdw, jdb = vjp(_j(dy, jdt))
    jmean, jrstd = res[2][:, 0], res[3][:, 0]

    ty, tmean, trstd = tln.layer_norm_fwd(_t(x, tdt), _t(w), _t(b), 1e-5)
    tdx, tdw, tdb = tln.layer_norm_bwd(_t(x, tdt), _t(w), tmean, trstd,
                                       _t(dy, tdt))
    assert ty.dtype == tdx.dtype == tdt
    assert tmean.dtype == trstd.dtype == tdw.dtype == torch.float32
    _close(ty, jy, tol)
    _close(tmean, jmean, 1e-5, scale=True)
    _close(trstd, jrstd, 1e-5, scale=True)
    _close(tdx.float(), jdx, tol, scale=True)
    if affine:
        _close(tdw, jdw, 1e-5, scale=True)
        _close(tdb, jdb, 1e-5, scale=True)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_autograd_function_matches_jax_vjp(dtype):
    jdt, tdt, tol = DTYPES[dtype]
    x, w, b, dy = _inputs(1, 48, 256, True)
    _, vjp = jax.vjp(lambda x_, w_, b_: lnp.layer_norm(x_, w_, b_, 1e-5,
                                                        True),
                     _j(x, jdt), _j(w), _j(b))
    jgrads = vjp(_j(dy, jdt))
    tx = _t(x, tdt).requires_grad_()
    tw, tb = _t(w).requires_grad_(), _t(b).requires_grad_()
    ty = tln.layer_norm(tx, tw, tb, 1e-5)
    ty.backward(_t(dy, tdt))
    for got, want in zip((tx.grad, tw.grad, tb.grad), jgrads):
        _close(got.float(), want, tol if got is tx.grad else 1e-5,
               scale=True)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("shape", [(4, 6, 64), (3, 5, 768), (2, 3, 100),
                                   (2, 12288)])
def test_fused_layer_norm_module_matches_jax_module(dtype, shape):
    jdt, tdt, tol = DTYPES[dtype]
    hidden = shape[-1]
    rs = np.random.RandomState(2)
    x = (rs.randn(*shape) * 2 + 1).astype(np.float32)
    dy = rs.randn(*shape).astype(np.float32)
    w = (rs.rand(hidden) + 0.5).astype(np.float32)
    b = rs.randn(hidden).astype(np.float32)
    jmod = JFusedLayerNorm(normalized_shape=hidden, eps=1e-5)
    params = {"params": {"weight": jnp.asarray(w), "bias": jnp.asarray(b)}}
    jy, vjp = jax.vjp(lambda p, x_: jmod.apply(p, x_), params,
                      _j(x, jdt))
    jp, jdx = vjp(_j(dy, jdt))

    tmod = FusedLayerNorm(hidden, eps=1e-5, device="cpu")
    assert tmod.weight.dtype == torch.float32
    assert [n for n, _ in tmod.named_parameters()] == ["weight", "bias"]
    with torch.no_grad():
        tmod.weight.copy_(_t(w))
        tmod.bias.copy_(_t(b))
    tx = _t(x, tdt).requires_grad_()
    ty = tmod(tx)
    ty.backward(_t(dy, tdt))
    assert ty.dtype == tdt and ty.shape == tx.shape
    _close(ty, jy, tol)
    _close(tx.grad.float(), jdx, tol, scale=True)
    _close(tmod.weight.grad, jp["params"]["weight"], 1e-5, scale=True)
    _close(tmod.bias.grad, jp["params"]["bias"], 1e-5, scale=True)


def test_no_affine_and_multi_axis_match_the_jnp_path():
    rs = np.random.RandomState(3)
    x = rs.randn(4, 6, 32).astype(np.float32)
    for shape in ((32,), (6, 32)):
        want = jfused_layer_norm(jnp.asarray(x), shape, None, None, 1e-5)
        got = fused_layer_norm(torch.from_numpy(x), shape, None, None, 1e-5)
        _close(got, want, 1e-5)
    mod = FusedLayerNorm(32, elementwise_affine=False, device="cpu")
    assert list(mod.parameters()) == []


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("norm", [(6, 32), (64, 200)])
def test_multi_axis_affine_matches_the_jnp_path_with_gradients(dtype, norm):
    """Two normalized axes run as rows of width 6 * 32, or 64 * 200 =
    12800 (weight and bias flattened alike) and match the JAX jnp path
    and its gradients."""
    jdt, tdt, tol = DTYPES[dtype]
    rs = np.random.RandomState(4)
    x = (rs.randn(4, *norm) * 2 + 1).astype(np.float32)
    dy = rs.randn(4, *norm).astype(np.float32)
    w = (rs.rand(*norm) + 0.5).astype(np.float32)
    b = rs.randn(*norm).astype(np.float32)
    jy, vjp = jax.vjp(
        lambda x_, w_, b_: jfused_layer_norm(x_, norm, w_, b_, 1e-5),
        _j(x, jdt), _j(w), _j(b))
    jdx, jdw, jdb = vjp(_j(dy, jdt))

    tx = _t(x, tdt).requires_grad_()
    tw, tb = _t(w).requires_grad_(), _t(b).requires_grad_()
    ty = fused_layer_norm(tx, norm, tw, tb, 1e-5)
    ty.backward(_t(dy, tdt))
    assert ty.dtype == tdt and ty.shape == tx.shape
    assert tw.grad.shape == tb.grad.shape == norm
    _close(ty, jy, tol)
    _close(tx.grad.float(), jdx, tol, scale=True)
    _close(tw.grad, jdw, 1e-5, scale=True)
    _close(tb.grad, jdb, 1e-5, scale=True)


def test_module_defaults_to_cuda_and_refuses_a_wrong_tail(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        FusedLayerNorm(64)
    with pytest.raises(ValueError, match="normalized_shape"):
        fused_layer_norm(torch.zeros(2, 8), (16,))


# plan(): the body and vector width the CUDA kernels take at each width
PLAN_WIDTHS = {1: ("rows", 1, 1), 2: ("rows", 2, 2), 12: ("rows", 4, 4),
               36: ("rows", 4, 4), 100: ("rows", 4, 4), 200: ("rows", 8, 4),
               768: ("rows", 8, "team"), 8192: ("team", 8, 8),
               8200: ("wide", 8, 4), 12288: ("wide", 8, 4),
               12800: ("wide", 8, 4)}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32])
@pytest.mark.parametrize("hidden", sorted(PLAN_WIDTHS))
def test_plan_picks_the_body_and_a_vector_every_row_start_aligns_to(
        dtype, hidden):
    """``plan()`` at each width: the body, the widest vector (at most 16
    bytes) dividing the row, whose alignment then holds at every row
    start; the rows body's lanes and at most 4 vectors a lane cover the
    row; the grids walk rows (one or two blocks an SM) where the body
    does, the wide K3 runs a block a row, and the team body keeps the
    parent's grids."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    body, half_vec, f32 = PLAN_WIDTHS[hidden]
    want_body, want_vec = ((body, half_vec) if itemsize == 2 else
                           (("team", 8) if f32 == "team" else (body, f32)))
    for rows in (1, 37, 8192):
        for backward in (False, True):
            p = lnc.plan(rows, hidden, dtype, 132, backward)
            # K3's wide body is the parent's: groups of 8 (16-byte halves
            # for fp32)
            vec = 8 if p.body == "wide" and not backward else want_vec
            assert (p.body, p.vec) == (want_body, vec), p
            align, w_align = lnc.plan_alignment(p, itemsize)
            assert align == min(16, p.vec * itemsize) and 16 % w_align == 0
            assert all((r * hidden * itemsize) % align == 0
                       for r in range(rows))
            if p.body == "rows":
                nvec = hidden // p.vec
                assert p.lanes in (1, 2, 4, 8, 16, 32)
                assert nvec <= 4 * p.lanes and (p.lanes == 1
                                                 or nvec > 2 * p.lanes)
                blocks = -(-rows // (8 * (32 // p.lanes)))
                walk = 132 if backward else max(132, min(264, -(-blocks // 2)))
                assert p.grid == min(blocks, walk)
            elif p.body == "wide":
                assert p.lanes == (128 if hidden <= 128 * 24 else 512)
                assert p.grid == (min(rows, 132) if backward else rows)
            else:
                assert p.lanes * 4 * 8 >= hidden and p.vec == 8
                if backward:
                    rpb = -(-rows // lnc.MAX_TEAM_BWD_BLOCKS)
                    assert p.grid == -(-rows // rpb) <= 256
                else:
                    assert p.grid * (256 // p.lanes) >= rows


def _tree(vals):
    """``((v0 + v1) + (v2 + v3)) + ...``: the kernels' pairwise tree over
    a power-of-two count, as ``a[i] += a[i + n]`` for n = half, ..., 1."""
    vals = list(vals)
    n = len(vals) // 2
    while n:
        vals = [vals[i] + vals[i + n] for i in range(n)]
        n //= 2
    return vals[0]


def _k4_mirror(c, p, rows):
    """K4's dw or db (``c`` the per-row contributions ``[rows, hidden]``,
    fp32) summed in the order of plan ``p``: each body's partial rows,
    then the second stage (16 slices, each adding its partial rows in
    order, then a pairwise tree)."""
    zero = torch.zeros_like(c[0])

    def seq(rs):
        acc = zero
        for r in rs:
            acc = acc + c[r]
        return acc

    parts = []
    if p.body == "rows":
        teams, warps = 32 // p.lanes, p.grid * lnc.ROW_WARPS
        step = warps * teams
        for blk in range(p.grid):
            per_warp = []
            for wib in range(lnc.ROW_WARPS):
                first = (blk * lnc.ROW_WARPS + wib) * teams
                team = [seq(range(first + k, rows, step))
                        for k in range(teams)]
                # the xor butterfly over the warp's teams: team 0's sum
                d = 1
                while d < teams:
                    team = [team[k] + team[k ^ d] for k in range(teams)]
                    d *= 2
                per_warp.append(team[0])
            parts.append(_tree(per_warp))
    elif p.body == "wide":
        parts = [seq(range(blk, rows, p.grid)) for blk in range(p.grid)]
    else:
        teams, rpb = 256 // p.lanes, -(-rows // p.grid)
        for blk in range(p.grid):
            r0, r1 = blk * rpb, min(rows, (blk + 1) * rpb)
            acc = zero
            for k in range(teams):
                acc = acc + seq(range(r0 + k, r1, teams))
            parts.append(acc)
    slices = [seq([]) for _ in range(16)]
    for s in range(16):
        for blk in range(s, len(parts), 16):
            slices[s] = slices[s] + parts[blk]
    return _tree(slices)


@pytest.mark.parametrize("rows,hidden,sm_count", [
    (1000, 768, 4), (8193, 36, 2), (37, 100, 132), (300, 12, 1),
    (200, 8200, 3), (700, 1032, 132)])
def test_k4_partials_in_the_kernels_order_match_the_plain_backward(
        rows, hidden, sm_count):
    """A plain mirror of K4's affine-gradient layout (the rows body's
    lanes, warp butterfly and block tree; the wide body's blocks; the
    team body's teams in order; then the second stage's slices and tree)
    sums dw and db to the plain backward's within 1e-6 of their scale,
    fp32."""
    x, w, _, dy = _inputs(7, rows, hidden, True)
    tx, tw, tdy = _t(x), _t(w), _t(dy)
    _, mean, rstd = tln.layer_norm_fwd(tx, tw, None, 1e-5)
    _, dw, db = tln.layer_norm_bwd(tx, tw, mean, rstd, tdy)
    p = lnc.plan(rows, hidden, torch.bfloat16, sm_count, backward=True)
    xhat = (tx - mean[:, None]) * rstd[:, None]
    _close(_k4_mirror(tdy * xhat, p, rows), dw, 1e-6, scale=True)
    _close(_k4_mirror(tdy, p, rows), db, 1e-6, scale=True)
