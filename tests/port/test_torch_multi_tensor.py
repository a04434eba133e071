"""Port parity of the multi-tensor substrate: ``apex_tpu_torch.
multi_tensor_apply`` and the plain versions of K12 and K13
(``apex_tpu_torch.ops.multi_tensor``) against ``apex_tpu.
multi_tensor_apply`` on the same seeded numpy inputs, on the CPU.

Tolerances: flatten, unflatten and the scale (one fp32 multiply an
element, cast) equal bit for bit, and so does every flag; axpby (two
products and a sum) within 1e-6 relative, as XLA may contract the sum
into a fused multiply-add; the norms within 1e-6 relative (fp32 sums in
another order: XLA's reduction tree against PyTorch's). The CUDA
wrappers' table rules (capacity under the 4 KB parameter limit, chunking,
grouping) are host arithmetic and are checked here too; the kernels
themselves are held to these plain versions on the card
(``test_torch_kernels_cuda.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.multi_tensor_apply import multi_tensor_apply as jmta
from apex_tpu.optimizers import grad_norm_stats as jgrad_norm_stats
from apex_tpu_torch.multi_tensor_apply import multi_tensor_apply as tmta
from apex_tpu_torch.ops import multi_tensor, multi_tensor_cuda
from apex_tpu_torch.optimizers import grad_norm_stats

SHAPES = [(5,), (3, 4), (2, 3, 2), (), (1,), (767,), (0,)]
DTYPES = {"float32": (np.float32, jnp.float32, torch.float32),
          "bfloat16": (None, jnp.bfloat16, torch.bfloat16)}


def _arrays(seed, shapes=SHAPES, scale=1.0):
    rs = np.random.RandomState(seed)
    return [np.asarray(rs.randn(*s) * scale, dtype=np.float32)
            for s in shapes]


def _pair(arrays, dtype="float32"):
    """The same values as JAX arrays and torch tensors of ``dtype``
    (bf16 through fp32, the same rounding on both sides)."""
    _, jdt, tdt = DTYPES[dtype]
    return ([jnp.asarray(a).astype(jdt) for a in arrays],
            [torch.from_numpy(a.copy()).to(tdt) for a in arrays])


def _np(t):
    return t.detach().float().numpy() if torch.is_tensor(t) \
        else np.asarray(t, np.float32)


def test_flatten_and_unflatten_match_jax():
    jx, tx = _pair(_arrays(0))
    jflat, tflat = jmta.flatten(jx), tmta.flatten(tx)
    assert np.array_equal(_np(tflat), _np(jflat))
    like_j, like_t = _pair(_arrays(1), "bfloat16")
    for j, t in zip(jmta.unflatten(jflat, like_j),
                    tmta.unflatten(tflat, like_t)):
        assert t.dtype == torch.bfloat16 and tuple(t.shape) == j.shape
        assert np.array_equal(_np(t), _np(j))
    assert tmta.flatten([], device="cpu").shape == (0,)


@pytest.mark.parametrize("src,dst", [("float32", "float32"),
                                     ("bfloat16", "float32"),
                                     ("float32", "bfloat16")])
@pytest.mark.parametrize("poison", [None, np.inf, np.nan, 3e38])
def test_multi_tensor_scale_matches_jax(src, dst, poison):
    arrays = _arrays(2)
    if poison is not None:
        arrays[2].flat[3] = poison
    jx, tx = _pair(arrays, src)
    jd, td = _pair(arrays, dst)
    jouts, jflag = jmta.multi_tensor_scale([jx, jd], 1024.0)
    touts, tflag = tmta.multi_tensor_scale([tx, td], 1024.0)
    assert tflag.dtype == torch.int32 and tflag.dim() == 0
    assert int(tflag) == int(jflag) == int(poison is not None)
    for j, t in zip(jouts, touts):
        assert t.dtype == DTYPES[dst][2]
        assert np.array_equal(_np(t), _np(j), equal_nan=True)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("poison", [None, np.inf])
def test_multi_tensor_axpby_matches_jax(dtype, poison):
    xs, ys = _arrays(3), _arrays(4)
    if poison is not None:
        ys[1].flat[0] = poison
    jx, tx = _pair(xs, dtype)
    jy, ty = _pair(ys, dtype)
    jo, to = _pair(_arrays(5), dtype)
    jouts, jflag = jmta.multi_tensor_axpby([jx, jy, jo], 0.37, -1.5)
    touts, tflag = tmta.multi_tensor_axpby([tx, ty, to], 0.37, -1.5)
    assert int(tflag) == int(jflag) == int(poison is not None)
    for j, t in zip(jouts, touts):
        np.testing.assert_allclose(_np(t), _np(j), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_norms_and_grad_stats_match_jax(dtype):
    jx, tx = _pair(_arrays(6, scale=3.0), dtype)
    np.testing.assert_allclose(_np(tmta.multi_tensor_l2norm(tx)),
                               _np(jmta.multi_tensor_l2norm(jx)), rtol=1e-6)
    jg, jper = jmta.multi_tensor_l2norm_per_tensor(jx)
    tg, tper = tmta.multi_tensor_l2norm_per_tensor(tx)
    np.testing.assert_allclose(_np(tg), _np(jg), rtol=1e-6)
    np.testing.assert_allclose(_np(tper), _np(jper), rtol=1e-6)
    live = [i for i, a in enumerate(tx) if a.numel()]
    jstats = jgrad_norm_stats([jx[i] for i in live])
    tstats = grad_norm_stats([tx[i] for i in live])
    for k in ("grad_norm", "grad_max"):
        np.testing.assert_allclose(_np(tstats[k]), _np(jstats[k]), rtol=1e-6)
    norms = multi_tensor.l2norm(tx, max_mode=True)
    assert _np(norms.per_tensor)[-1] == 0.0   # the empty tensor
    assert _np(norms.total) == _np(jstats["grad_max"])


def test_empty_lists_take_the_device_they_are_given(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tmta.multi_tensor_l2norm([])
    with pytest.raises(RuntimeError, match="CUDA"):
        grad_norm_stats({})
    assert _np(tmta.multi_tensor_l2norm([], device="cpu")) == 0.0
    g, per = tmta.multi_tensor_l2norm_per_tensor([], device="cpu")
    assert _np(g) == 0.0 and per.shape == (0,)
    outs, flag = tmta.multi_tensor_scale([[], []], 2.0, device="cpu")
    assert outs == [] and int(flag) == 0 and flag.dtype == torch.int32
    assert grad_norm_stats({}, device="cpu")["grad_max"].item() == 0.0


def test_applier_and_fused_elementwise_update_match_jax():
    jx, tx = _pair(_arrays(7))
    jy, ty = _pair(_arrays(8), "bfloat16")
    japp = jmta.MultiTensorApply(2048)
    tapp = tmta.MultiTensorApply(2048)
    assert tmta.MultiTensorApply.check_avail() is None and tapp.available
    jouts, _ = japp(jmta.multi_tensor_scale, None, [jx, jx], 0.5)
    touts, _ = tapp(tmta.multi_tensor_scale, None, [tx, tx], 0.5)
    touts2, _ = tmta.multi_tensor_applier(tmta.multi_tensor_scale,
                                          [tx, tx], 0.5)
    for j, t, t2 in zip(jouts, touts, touts2):
        assert np.array_equal(_np(t), _np(j)) and torch.equal(t, t2)

    def fn(a, b):
        return a * 2.0 + b, a - b

    names = [f"w{i}" for i in range(len(tx))]
    jout = jmta.fused_elementwise_update(fn, dict(zip(names, jx)),
                                         dict(zip(names, jy)))
    tout = tmta.fused_elementwise_update(fn, dict(zip(names, tx)),
                                         dict(zip(names, ty)))
    for jtree, ttree in zip(jout, tout):
        for n in names:
            assert ttree[n].dtype == (torch.float32 if jtree is jout[0]
                                      else torch.bfloat16)
            assert np.array_equal(_np(ttree[n]), _np(jtree[n]))


def test_cuda_wrappers_refuse_cpu_tensors_and_split_lists_by_capacity():
    """No quiet fallback: a CPU list given to a CUDA wrapper raises; the
    tables of a launch stay under the 4 KB parameter limit."""
    x = [torch.ones(3)]
    with pytest.raises(ValueError, match="CUDA"):
        multi_tensor_cuda.scale(x, [torch.float32], 2.0)
    with pytest.raises(ValueError, match="CUDA"):
        multi_tensor_cuda.l2norm(x)
    with pytest.raises(ValueError, match="empty"):
        multi_tensor_cuda.l2norm([])
    for depth in (1, 2, 3, 4):
        cap = multi_tensor_cuda.capacity(depth)
        # pointers, a size and a chunk start a tensor, and the header
        assert cap * (8 * depth + 8) + 16 <= multi_tensor_cuda.TABLE_BYTES
        groups = multi_tensor_cuda._groups(list(range(2 * cap + 1)), depth)
        assert [len(g) for g in groups] == [cap, cap, 1]
    # GPT-2-small's 148 leaves: one unscale launch; a depth-4 table (K16's)
    # holds fewer (K14 and K15 take whole lists: test_torch_multi_tensor_plan)
    assert multi_tensor_cuda.capacity(2) >= 148 > multi_tensor_cuda.capacity(4)
    chunk = multi_tensor_cuda.CHUNK
    assert [multi_tensor_cuda.chunks(n) for n in (0, 1, chunk, chunk + 1)] \
        == [0, 1, 1, 2]
