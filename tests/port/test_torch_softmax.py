"""Port parity of the fused softmax: ``apex_tpu_torch.ops.softmax`` (the
plain versions of K10 and K11, and the differentiable call that runs them
on the CPU) against ``apex_tpu.ops.softmax_pallas.scaled_masked_softmax``
in interpret mode, forward and backward (``jax.vjp``), and
``apex_tpu_torch.transformer.functional.FusedScaleMaskSoftmax`` against
JAX's on both of its branches.

Cases: causal, an explicit ``[b, 1, sq, sk]`` mask (broadcast over heads),
a ``[b, np, sq, sk]`` mask, a fully masked row, with a non-unit scale; a
key-padding ``[b, 1, 1, sk]`` mask through ``FusedScaleMaskSoftmax``; the
generic variant at 5000 and 8192 keys (K10L/K11L's rows on the card)
against JAX's, which takes its jnp function there. K10L's
``softmax_cuda.long_plan`` at the edges of its bodies, and a plain mirror
of its walking body's arithmetic (an online max and sum a thread, the
pairs combined over the block) against the plain softmax in fp32.
Bands: fp32 within 1e-6 of the largest magnitude, at least 1 (the same
fp32 operations; the row sums run in another order); bf16 within one
bf16 ulp of the output (both round the same fp32 value, which can sit
either side of a rounding boundary).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.ops import softmax_pallas as jsp
from apex_tpu.transformer.enums import AttnMaskType as JMask
from apex_tpu.transformer.functional import fused_softmax as jfs
from apex_tpu_torch.ops import softmax as tsm
from apex_tpu_torch.ops import softmax_cuda
from apex_tpu_torch.transformer import enums as tenums
from apex_tpu_torch.transformer.functional import fused_softmax as tfs

torch.set_num_threads(2)

B, NP, SQ, SK = 2, 4, 128, 128
CASES = ["causal", "mask_b1", "mask_bnp", "masked_row"]


def _case(case, seed=0):
    rs = np.random.RandomState(seed)
    x = (rs.randn(B, NP, SQ, SK) * 3).astype(np.float32)
    g = rs.randn(B, NP, SQ, SK).astype(np.float32)
    mask, causal = None, case == "causal"
    if case == "mask_b1":
        mask = rs.rand(B, 1, SQ, SK) < 0.3
    elif case in ("mask_bnp", "masked_row"):
        mask = rs.rand(B, NP, SQ, SK) < 0.3
    if case == "masked_row":
        mask[0, 1, 7] = True            # every position of one row masked
        mask[1, 3, :, :5] = True
    return x, g, mask, causal


def _bf16_ulp(x):
    """One bf16 ulp of each element's magnitude (8 significant bits)."""
    a = np.maximum(np.abs(x), np.finfo(np.float32).tiny)
    return 2.0 ** (np.floor(np.log2(a)) - 7)


def _close(got, want, dtype):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    if dtype == "float32":
        scale = max(float(np.abs(want).max()), 1.0)
        np.testing.assert_allclose(got, want, atol=1e-6 * scale, rtol=0)
    else:
        err = np.abs(got - want)
        band = _bf16_ulp(np.maximum(np.abs(got), np.abs(want)))
        assert (err <= band).all(), float((err - band).max())
        assert ((got == 0) == (want == 0)).all()


def _to(x, dtype):
    return torch.from_numpy(x).to(getattr(torch, dtype))


def _jx(x, dtype):
    return jnp.asarray(x, getattr(jnp, dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES)
def test_plain_forward_and_backward_match_the_jax_kernel(dtype, case):
    x, g, mask, causal = _case(case)
    scale = 0.37
    jmask = None if mask is None else jnp.asarray(mask)

    def f(xx):
        return jsp.scaled_masked_softmax(xx, jmask, scale, causal, True)

    jy, vjp = jax.vjp(f, _jx(x, dtype))
    (jdx,) = vjp(_jx(g, dtype))
    tmask = None if mask is None else torch.from_numpy(mask)
    ty = tsm.scaled_masked_softmax_reference(_to(x, dtype), tmask, scale,
                                             causal)
    assert ty.dtype == getattr(torch, dtype)
    _close(ty.float().numpy(), np.asarray(jy, np.float32), dtype)
    tdx = tsm.scaled_masked_softmax_backward_reference(ty, _to(g, dtype),
                                                       scale)
    # the backward from the port's own y: both sides start from JAX's y
    # here, so the check is the VJP's arithmetic alone
    tdx_j = tsm.scaled_masked_softmax_backward_reference(
        _to(np.asarray(jy, np.float32), dtype), _to(g, dtype), scale)
    _close(tdx_j.float().numpy(), np.asarray(jdx, np.float32), dtype)
    if dtype == "float32":
        _close(tdx.numpy(), np.asarray(jdx), dtype)
    if case == "masked_row":
        assert (ty[0, 1, 7] == 0).all(), "a fully masked row gives 0"
    if causal:
        tri = np.triu(np.ones((SQ, SK), bool), 1)
        assert (ty.float().numpy()[..., tri] == 0).all()


@pytest.mark.parametrize("case", CASES)
def test_autograd_call_runs_the_plain_versions_on_the_cpu(case):
    x, g, mask, causal = _case(case, seed=1)
    tmask = None if mask is None else torch.from_numpy(mask)
    tx = torch.from_numpy(x).requires_grad_()
    y = tsm.scaled_masked_softmax(tx, tmask, 1.5, causal)
    y.backward(torch.from_numpy(g))
    want = tsm.scaled_masked_softmax_reference(tx.detach(), tmask, 1.5,
                                               causal)
    assert torch.equal(y.detach(), want)
    assert torch.equal(tx.grad, tsm.scaled_masked_softmax_backward_reference(
        want, torch.from_numpy(g), 1.5))
    # an int8 mask is the same mask
    if tmask is not None:
        y8 = tsm.scaled_masked_softmax(tx.detach(), tmask.to(torch.int8),
                                       1.5, causal)
        assert torch.equal(y8, want)


def test_shape_predicates_and_refusals():
    x = torch.zeros(B, NP, SQ, SK)
    # every mask JAX's kernel takes, K10 takes too
    for shape in ((B, 1, SQ, SK), (B, NP, SQ, SK)):
        m = np.zeros(shape, bool)
        assert tsm.mask_supported(torch.from_numpy(m), x.shape)
        assert jsp.mask_supported(jnp.asarray(m), x.shape)
    # and every other mask that broadcasts along the leading axes (K10
    # reads an axis of size 1 at stride 0), where JAX falls back to jnp
    for shape in ((B, 1, 1, SK), (1, NP, SQ, SK), (SQ, SK), (SK,)):
        m = np.zeros(shape, bool)
        assert tsm.mask_supported(torch.from_numpy(m), x.shape), shape
        assert not jsp.mask_supported(jnp.asarray(m), x.shape), shape
    for shape in ((B, 2, SQ, SK), (B, 1, SQ, 1), (B, 1, SQ, SK // 2),
                  (1, B, 1, SQ, SK)):
        assert not tsm.mask_supported(torch.zeros(shape, dtype=torch.bool),
                                      x.shape), shape
    # the CUDA kernels' own limits: any row count, any number of keys
    # (K10/K11 up to 4096, K10L/K11L above)
    assert tsm.supported(1, 100) and tsm.supported(4, 4096)
    assert tsm.supported(4, 4097) and tsm.supported(1, 1 << 20)
    assert not tsm.supported(0, 128) and not tsm.supported(4, 0)
    with pytest.raises(ValueError, match="broadcast"):
        tsm.scaled_masked_softmax(x, torch.zeros(B, 2, SQ, SK,
                                                 dtype=torch.bool))
    with pytest.raises(ValueError, match="sk"):
        tsm.scaled_masked_softmax(x[0])
    with pytest.raises(ValueError, match="sk"):
        tsm.scaled_masked_softmax(torch.zeros(1, 1, 2, 0))
    # rows over 4096 keys take the same call on the CPU as on the card
    assert torch.equal(tsm.scaled_masked_softmax(torch.zeros(1, 1, 2, 4097)),
                       torch.full((1, 1, 2, 4097), 1 / 4097))


def test_key_padding_mask_takes_the_kernel_call_and_matches_jax(
        monkeypatch):
    """A key-padding ``[b, 1, 1, sk]`` mask: the port's module takes the
    kernel's call (K10 broadcasts the mask by index; on the CPU its plain
    version runs). JAX's kernel takes no such mask, so JAX is given the
    same mask expanded to ``[b, 1, sq, sk]`` and runs its Pallas kernel
    (interpret mode); the two agree, forward and gradient, in the bands of
    the kernel-branch test, and ``use_pallas=False`` gives the same
    numbers."""
    monkeypatch.setenv("APEX_PALLAS_INTERPRET", "1")
    monkeypatch.setenv("APEX_DISPATCH", "off")
    calls = _jax_counted(monkeypatch)
    port_calls = []
    kernel = tsm.scaled_masked_softmax
    monkeypatch.setattr(tsm, "scaled_masked_softmax",
                        lambda *a, **k: port_calls.append(1) or kernel(*a,
                                                                       **k))
    x, g, _, _ = _case("none", seed=5)
    live = np.array([SK - 37, SK - 90])
    pad = np.arange(SK)[None, None, None, :] >= live[:, None, None, None]
    j = jfs.FusedScaleMaskSoftmax(False, True, JMask.padding, True,
                                  _mask_func(jfs), True, 2.0,
                                  use_pallas=True)
    t = tfs.FusedScaleMaskSoftmax(False, True, tenums.AttnMaskType.padding,
                                  True, _mask_func(tfs), True, 2.0)
    jpad = jnp.asarray(np.broadcast_to(pad, (B, 1, SQ, SK)))
    jy, vjp = jax.vjp(lambda xx: j(xx, jpad), _jx(x, "bfloat16"))
    (jdx,) = vjp(_jx(g, "bfloat16"))
    assert calls == [True], "the JAX Pallas kernel did not run"
    tx = _to(x, "bfloat16").requires_grad_()
    ty = t(tx, torch.from_numpy(pad))
    ty.backward(_to(g, "bfloat16"))
    assert port_calls == [1], "the port did not take the kernel's call"
    _close(ty.detach().float().numpy(), np.asarray(jy, np.float32),
           "bfloat16")
    # the gradient within 2 ulps of the row's largest, as in the kernel
    # branch's test, plus an fp32 floor: a row whose y is 1 at one key
    # (the x here reach 3 sigma at scale 2) has g - sum(g * y) near 0, so
    # its gradient is the residue of an fp32 cancellation and the two
    # sides' summation orders show at a few fp32 ulps of |g| (~1), not at
    # a bf16 ulp of the residue
    jdx, tdx = np.asarray(jdx, np.float32), tx.grad.float().numpy()
    row_max = np.abs(jdx).max(axis=-1, keepdims=True)
    assert (np.abs(tdx - jdx) <= 2 * _bf16_ulp(row_max) + 2.0 ** -20).all()
    assert (ty.detach().float().numpy()[np.broadcast_to(pad, ty.shape)]
            == 0).all()
    t_plain = tfs.FusedScaleMaskSoftmax(
        False, True, tenums.AttnMaskType.padding, True, _mask_func(tfs),
        True, 2.0, use_pallas=False)
    assert torch.equal(t_plain(tx.detach(), torch.from_numpy(pad)),
                       ty.detach())


def test_dispatch_predicate_is_the_jax_one():
    for mask_type in ("causal", "padding"):
        j = jfs.FusedScaleMaskSoftmax(False, True, getattr(JMask, mask_type),
                                      True, None, True, None)
        t = tfs.FusedScaleMaskSoftmax(False, True,
                                      getattr(tenums.AttnMaskType, mask_type),
                                      True, None, True, None)
        for b, np_, sq, sk in [(2, 4, 128, 128), (1, 2, 64, 64),
                               (2, 2, 16, 16), (2, 6, 1024, 1024),
                               (3, 4, 12, 20), (8, 12, 1024, 4096),
                               (1, 4, 32, 5000), (2, 3, 128, 128)]:
            assert t.is_kernel_available(None, b, np_, sq, sk) \
                == j.is_kernel_available(None, b, np_, sq, sk), \
                (mask_type, b, np_, sq, sk)
            assert t.get_batch_per_block(sq, sk, b, np_) \
                == j.get_batch_per_block(sq, sk, b, np_)
    g = tfs.GenericFusedScaleMaskSoftmax(True, False, None, True, None)
    assert g.is_kernel_available(None, 1, 1, 3, 5000)
    # rows over 4096 keys take the kernel call (K10L on the card) and give
    # what JAX's generic variant gives; use_pallas=False the same numbers
    x = torch.zeros(1, 1, 4, 5000, dtype=torch.float16)
    jg = jfs.GenericFusedScaleMaskSoftmax(True, False, None, True, None)
    want = np.asarray(jg(jnp.zeros((1, 1, 4, 5000), jnp.float16), None))
    np.testing.assert_array_equal(g(x, None).numpy(), want)
    plain = tfs.GenericFusedScaleMaskSoftmax(True, False, None, True, None,
                                             use_pallas=False)(x, None)
    assert torch.equal(plain, torch.full_like(x, 1 / 5000))
    for bad in ("yes", None):
        with pytest.raises(ValueError, match="use_pallas"):
            tfs.FusedScaleMaskSoftmax(False, True,
                                      tenums.AttnMaskType.causal, True, None,
                                      True, None, use_pallas=bad)


@pytest.mark.parametrize("sk", [5000, 8192])
@pytest.mark.parametrize("dtype", ["float16", "bfloat16"])
@pytest.mark.parametrize("masked", [False, True], ids=["no_mask", "mask_b1"])
def test_generic_softmax_serves_long_rows_as_jax_does(sk, dtype, masked):
    """Rows over the kernels' old 4096-key limit: the port's generic
    variant at its default ``use_pallas=True`` takes the kernel call (its
    plain version on the CPU, K10L on the card) and equals JAX's generic
    variant, which takes its jnp function there, in fp32 within 1e-6."""
    rs = np.random.RandomState(sk)
    x = (rs.randn(2, 2, 8, sk) * 3).astype(np.float32)
    mask = rs.rand(2, 1, 8, sk) < 0.3 if masked else None
    fp16 = dtype == "float16"
    j = jfs.GenericFusedScaleMaskSoftmax(fp16, not fp16, None, True, 2.0)
    t = tfs.GenericFusedScaleMaskSoftmax(fp16, not fp16, None, True, 2.0)
    assert t.use_pallas and t.is_kernel_available(mask, 2, 2, 8, sk)
    jy = j(_jx(x, dtype), None if mask is None else jnp.asarray(mask))
    ty = t(_to(x, dtype), None if mask is None else torch.from_numpy(mask))
    assert ty.dtype == getattr(torch, dtype)
    _close(ty.float().numpy(), np.asarray(jy, np.float32), "float32")
    if masked:
        assert (ty.float().numpy()[np.broadcast_to(mask, ty.shape)]
                == 0).all()


def _mask_func(module):
    def f(scores, mask):
        if module is tfs:
            return torch.where(mask, torch.tensor(-10000.0,
                                                  dtype=scores.dtype), scores)
        return jnp.where(mask, jnp.asarray(-10000.0, scores.dtype), scores)
    return f


def _jax_counted(monkeypatch):
    calls = []
    kernel = jsp.scaled_masked_softmax

    def counted(*args, **kwargs):
        calls.append(kwargs.get("interpret", args[4] if len(args) > 4
                                else False))
        return kernel(*args, **kwargs)

    monkeypatch.setattr(jsp, "scaled_masked_softmax", counted)
    return calls


@pytest.mark.parametrize("mask_type", ["causal", "padding"])
def test_fused_scale_mask_softmax_kernel_branch_matches_jax(monkeypatch,
                                                            mask_type):
    """bf16, the predicate true: JAX runs its Pallas kernel in interpret
    mode (``APEX_PALLAS_INTERPRET=1``), the port its kernel's plain
    version through the same autograd function; forward and gradient."""
    monkeypatch.setenv("APEX_PALLAS_INTERPRET", "1")
    monkeypatch.setenv("APEX_DISPATCH", "off")
    calls = _jax_counted(monkeypatch)
    x, g, mask, _ = _case("mask_b1", seed=2)
    scale = 2.0
    j = jfs.FusedScaleMaskSoftmax(False, True, getattr(JMask, mask_type),
                                  True, _mask_func(jfs), True, scale,
                                  use_pallas=True)
    t = tfs.FusedScaleMaskSoftmax(False, True,
                                  getattr(tenums.AttnMaskType, mask_type),
                                  True, _mask_func(tfs), True, scale,
                                  use_pallas=True)
    assert t.is_kernel_available(mask, B, NP, SQ, SK)
    jm = jnp.asarray(mask)
    jy, vjp = jax.vjp(lambda xx: j(xx, jm), _jx(x, "bfloat16"))
    (jdx,) = vjp(_jx(g, "bfloat16"))
    assert calls == [True], "the JAX Pallas kernel did not run"
    tx = _to(x, "bfloat16").requires_grad_()
    ty = t(tx, torch.from_numpy(mask))
    ty.backward(_to(g, "bfloat16"))
    assert ty.dtype == torch.bfloat16
    _close(ty.detach().float().numpy(), np.asarray(jy, np.float32),
           "bfloat16")
    # the gradient from each side's own y: an output one ulp apart moves
    # the row's dot product, so hold it within 2 ulps of the largest
    # gradient of the row
    jdx, tdx = np.asarray(jdx, np.float32), tx.grad.float().numpy()
    row_max = np.abs(jdx).max(axis=-1, keepdims=True)
    assert (np.abs(tdx - jdx) <= 2 * _bf16_ulp(row_max)).all()
    # use_pallas=False pins the plain function: the same numbers
    t_plain = tfs.FusedScaleMaskSoftmax(
        False, True, getattr(tenums.AttnMaskType, mask_type), True,
        _mask_func(tfs), True, scale, use_pallas=False)
    _close(t_plain(tx.detach(), torch.from_numpy(mask)).float().numpy(),
           ty.detach().float().numpy(), "bfloat16")


def test_fused_scale_mask_softmax_torch_branch_matches_jax(monkeypatch):
    """fp32, the predicate false (fp32 input): ``forward_torch_softmax``
    with the synthesized causal mask, the scale and ``mask_func``."""
    monkeypatch.setenv("APEX_DISPATCH", "off")
    calls = _jax_counted(monkeypatch)
    x, g, _, _ = _case("causal", seed=3)
    j = jfs.FusedScaleMaskSoftmax(False, False, JMask.causal, True,
                                  _mask_func(jfs), True, 3.0,
                                  use_pallas=True)
    t = tfs.FusedScaleMaskSoftmax(False, False, tenums.AttnMaskType.causal,
                                  True, _mask_func(tfs), True, 3.0,
                                  use_pallas=True)
    assert not t.is_kernel_available(None, B, NP, SQ, SK)
    jy, vjp = jax.vjp(lambda xx: j(xx, None), jnp.asarray(x))
    (jdx,) = vjp(jnp.asarray(g))
    assert calls == []
    tx = torch.from_numpy(x).requires_grad_()
    ty = t(tx, None)
    ty.backward(torch.from_numpy(g))
    _close(ty.detach().numpy(), np.asarray(jy), "float32")
    _close(tx.grad.numpy(), np.asarray(jdx), "float32")


def test_apply_surfaces_match_jax():
    x, _, mask, _ = _case("mask_bnp", seed=4)
    xb = x.reshape(B * NP, SQ, SK)
    _close(tfs.ScaledUpperTriangMaskedSoftmax.apply(torch.from_numpy(xb),
                                                    0.5).numpy(),
           np.asarray(jfs.ScaledUpperTriangMaskedSoftmax.apply(
               jnp.asarray(xb), 0.5)), "float32")
    for tcls, jcls in ((tfs.ScaledMaskedSoftmax, jfs.ScaledMaskedSoftmax),
                       (tfs.GenericScaledMaskedSoftmax,
                        jfs.GenericScaledMaskedSoftmax)):
        _close(tcls.apply(torch.from_numpy(x), torch.from_numpy(mask),
                          0.5).numpy(),
               np.asarray(jcls.apply(jnp.asarray(x), jnp.asarray(mask),
                                     0.5)), "float32")


@pytest.mark.parametrize("itemsize", [2, 4])
def test_long_plan_bodies_and_edges(itemsize):
    """bf16/fp16 rows to 8192 keys on the register body (the fewest warps
    at 32 fp32 values a thread: 8192 keys take 256 threads), then the smem
    body while a 16-byte slot and a mask byte a vector fit 102 KB (fp32
    from the first long row), about 8 vectors a thread, then the walking
    body; every plan covers its row."""
    plan = softmax_cuda.long_plan
    epv = 16 // itemsize
    smem_last = {2: 49152, 4: 24576}[itemsize]
    if itemsize == 2:
        assert plan(8192, 2) == ("regs", 256, 0)
        assert plan(5000, 2) == ("regs", 160, 0)
        assert plan(8193, 2).body == "smem"
    else:
        assert plan(4097, 4).body == "smem"
        assert plan(8192, 4) == ("smem", 256, 34816)
    assert plan(smem_last, itemsize) == ("smem", 512, 104448)
    assert plan(smem_last + 1, itemsize) == ("walk", 512, 0)
    last = None
    for sk in sorted([*range(1, 60000, 97), smem_last, smem_last + 1, 10**6]):
        p = plan(sk, itemsize)
        nvec = -(-sk // epv)
        assert p.threads % 32 == 0 and 32 <= p.threads <= 512
        if p.body == "regs":
            assert itemsize == 2 and p.threads <= 256 and p.smem == 0
            assert p.threads * (32 // epv) >= nvec > (p.threads - 32) * (
                32 // epv)
        elif p.body == "smem":
            assert nvec * 17 <= p.smem <= softmax_cuda.LONG_SMEM_MAX
            assert p.smem % 16 == 0
            assert p.threads == min(512, 32 * -(-nvec // 256))
        order = softmax_cuda.LONG_BODIES.index(p.body)
        assert last is None or order >= last, "bodies follow the length"
        last = order
    with pytest.raises(ValueError):
        plan(0, 2)
    with pytest.raises(ValueError):
        plan(100, 8)


def _walk_mirror(x, live, threads=512, epv=4):
    """K10L's walking body on one fp32 row in plain torch: thread t reads
    vectors t, t + threads, ...; a running (m, s) a thread over the live
    vectors (s rescaled where m moves; a masked element is -FLT_MAX in the
    max and 0 in the sum), then the block's max and the sums moved onto
    it; y from a second read."""
    sk = x.numel()
    fmin = torch.finfo(torch.float32).min
    m = torch.full((threads,), float("-inf"))
    s = torch.zeros(threads)
    col = torch.arange(sk)
    val = torch.where(col < live, x, torch.tensor(fmin))
    for c in range(0, live, threads * epv):
        for t in range(threads):
            c0 = c + t * epv
            if c0 >= live:
                break
            v = val[c0:c0 + epv]
            vm = torch.maximum(m[t], v.max())
            if vm != m[t]:
                s[t] = s[t] * torch.exp(m[t] - vm)
                m[t] = vm
            keep = col[c0:c0 + epv] < live
            s[t] = s[t] + torch.where(keep, torch.exp(v - m[t]), 0.0).sum()
    if live < sk:
        m = torch.maximum(m, torch.tensor(fmin))
    mx = m.max()
    sum_ = torch.where(s > 0, s * torch.exp(m - mx), 0.0).sum()
    y = torch.where(col < live, torch.exp(val - mx), 0.0)
    return y / sum_ if sum_ > 0 else torch.zeros_like(y)


@pytest.mark.parametrize("live", [1, 3, 2048, 5000])
def test_walking_body_arithmetic_matches_the_plain_softmax(live):
    """The online pairs a thread and their combination give the plain
    softmax within 1e-6 in fp32, the row's masked tail (causal) 0."""
    gen = torch.Generator().manual_seed(live)
    x = torch.randn(5000, generator=gen) * 4
    got = _walk_mirror(x, live, threads=64)
    want = torch.zeros_like(x)
    want[:live] = torch.softmax(x[:live], dim=0)
    torch.testing.assert_close(got, want, atol=1e-6, rtol=0)
