"""Port parity of the vocab-parallel fused LM head:
``apex_tpu_torch.ops.xent.linear_cross_entropy_sharded`` in 2 and 4
ranks (gloo on CPU tensors, the ranks in ``tp_workers.py``) against
``apex_tpu/ops/xent_pallas.py linear_cross_entropy_sharded`` on the
8-device CPU mesh (its Pallas kernels in interpret mode, as
``tests/test_xent_pallas.py:148`` runs it), and the plain
``linear_cross_entropy_partials`` against ``_fwd_partial_kernel`` in
interpret mode.

Shapes: n = 64, h = 128, V = 512, as ``tests/test_xent_pallas.py``.
Tolerances: fp32 loss, dX and each dE shard within 1e-5 of the tensor's
largest magnitude (the same fp32 math; the vocabulary chunks and the
cross-rank sums run in another order); the partials within 1e-6 of the
largest magnitude of each (the same chunked online max and sum).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu
from jax.sharding import Mesh, PartitionSpec as P

import tp_workers
from apex_tpu.ops import xent_pallas as xp
from apex_tpu_torch.ops import xent

N, H, V = 64, 128, 512
SMOOTHING = (0.0, 0.1)


def _case():
    rs = np.random.RandomState(0)
    x = rs.randn(N, H).astype(np.float32)
    e = (rs.randn(V, H) * 0.1).astype(np.float32)
    labels = rs.randint(0, V, (N,)).astype(np.int32)
    g = rs.randn(N).astype(np.float32)
    return x, e, labels, g


def _close(got, want, rel, name=""):
    want = np.asarray(want, np.float32)
    atol = rel * max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, atol=atol,
                               rtol=0, err_msg=name)


def _jax_sharded(tp, eps):
    x, e, labels, g = _case()
    mesh = Mesh(np.array(jax.devices()[:tp]), ("tp",))

    def sharded(x, e, labels, g):
        def f(args):
            xx, ee = args
            loss = xp.linear_cross_entropy_sharded(xx, ee, labels, "tp",
                                                   True, eps)
            return jnp.sum(loss * g), loss

        (_, loss), grads = jax.value_and_grad(f, has_aux=True)((x, e))
        return loss, grads[0], grads[1]

    out = jax.shard_map(sharded, mesh=mesh, in_specs=(P(), P("tp"), P(), P()),
                        out_specs=(P(), P(), P("tp")), check_vma=False)(
        jnp.asarray(x), jnp.asarray(e), jnp.asarray(labels), jnp.asarray(g))
    return [np.asarray(t) for t in out]


@pytest.fixture(scope="module", params=[2, 4], ids=["tp2", "tp4"])
def results(request):
    """Both sides at one tp, every smoothing: JAX's ``(loss, dX, dE)``
    and each rank's."""
    tp = request.param
    x, e, labels, g = _case()
    port = tp_workers.run_ranks(tp_workers.xent_case, tp, dict(
        x=x, e=e, labels=labels, g=g, smoothing=SMOOTHING))
    return tp, {eps: _jax_sharded(tp, eps) for eps in SMOOTHING}, port


@pytest.mark.parametrize("eps", SMOOTHING)
def test_sharded_head_matches_jax(results, eps):
    tp, jax_out, port = results
    loss_j, dx_j, de_j = jax_out[eps]
    vs = V // tp
    for rank, out in enumerate(port):
        loss, dx, de = out[eps]
        _close(loss, loss_j, 1e-5, f"loss rank {rank}")
        _close(dx, dx_j, 1e-5, f"dx rank {rank}")
        _close(de, de_j[rank * vs:(rank + 1) * vs], 1e-5, f"de rank {rank}")
    # every rank's loss and dX are the same numbers
    for out in port[1:]:
        assert np.array_equal(out[eps][0], port[0][eps][0])
        assert np.array_equal(out[eps][1], port[0][eps][1])


def _jax_partials(x, e, labels, eps):
    """``_fwd_partial_kernel :203`` through ``pallas_call`` in interpret
    mode, with the grid and specs ``_fwd_sharded :321`` gives it."""
    n, h = x.shape
    vs = e.shape[0]
    bv = xp._v_chunk(vs)
    br = xp._row_block(n, h, bv)
    xspec, espec, lspec = xp._common_specs(br, bv, h)
    n_part = 4 if eps else 3
    parts = pl.pallas_call(
        functools.partial(xp._fwd_partial_kernel, bv=bv, nv=vs // bv,
                          eps=float(eps)),
        grid=(n // br, vs // bv), in_specs=[xspec, espec, lspec],
        out_specs=(lspec,) * n_part,
        out_shape=(jax.ShapeDtypeStruct((n, 1), jnp.float32),) * n_part,
        scratch_shapes=[pltpu.VMEM((br, 1), jnp.float32)] * n_part,
        interpret=True,
    )(jnp.asarray(x), jnp.asarray(e), jnp.asarray(labels).reshape(n, 1))
    return [np.asarray(p)[:, 0] for p in parts]


@pytest.mark.parametrize("eps", SMOOTHING)
@pytest.mark.parametrize("rank", [0, 1])
def test_plain_partials_match_the_partial_kernel(eps, rank):
    """One shard of a tp = 2 split, labels local to it (half of them off
    the shard)."""
    x, e, labels, _ = _case()
    vs = V // 2
    es, local = e[rank * vs:(rank + 1) * vs], labels - rank * vs
    want = _jax_partials(x, es, local, eps)
    got = xent.linear_cross_entropy_partials(
        torch.from_numpy(x), torch.from_numpy(np.array(es)),
        torch.from_numpy(local), eps)
    assert all(t.dtype == torch.float32 and t.shape == (N,) for t in got)
    for name, a, b in zip("mstu", got, want):
        _close(a.numpy(), b, 1e-6, name)
    if not eps:
        assert torch.equal(got[3], torch.zeros(N))
    off = (local < 0) | (local >= vs)
    assert off.any() and (got[2].numpy()[off] == 0).all()
