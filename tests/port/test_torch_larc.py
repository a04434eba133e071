"""Port parity of LARC (``apex_tpu_torch.parallel.LARC``: the ``larc``
transform and the ``LARC`` class) against ``apex_tpu.parallel.LARC`` on
the CPU, inputs from a seeded numpy ``RandomState``.

The transform in clip and scale modes, with and without weight decay, on
a tree holding a zero parameter tensor and a zero gradient tensor (both
pass through untouched: no rate, no decay), within 1e-6 of each tensor's
largest magnitude (per-tensor norms summed in another order). The class
over the port's ``FusedSGD`` (momentum 0.9, weight decay 1e-4), two
steps, against JAX's ``optax.chain(larc(...), fused_sgd(..., weight_decay
=0))`` within 1e-6; the group's weight decay is zeroed around the inner
step and restored.
"""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from apex_tpu.optimizers.fused_sgd import fused_sgd as jfused_sgd
from apex_tpu.parallel import larc as jlarc
from apex_tpu_torch.optimizers import FusedSGD
from apex_tpu_torch.parallel import LARC, larc


def _tree(seed):
    rs = np.random.RandomState(seed)
    params = {"a": rs.randn(6, 5), "b": rs.randn(7), "z": np.zeros(4),
              "g0": rs.randn(3)}
    grads = {"a": rs.randn(6, 5) * 0.1, "b": rs.randn(7) * 3,
             "z": rs.randn(4), "g0": np.zeros(3)}
    cast = lambda t: {k: v.astype(np.float32) for k, v in t.items()}  # noqa: E731
    return cast(params), cast(grads)


def _close(got, want, rel=1e-6):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("clip", [True, False])
@pytest.mark.parametrize("wd", [0.0, 1e-2])
def test_larc_transform_matches_jax(clip, wd):
    params, grads = _tree(0)
    kw = dict(trust_coefficient=0.02, clip=clip, eps=1e-8, weight_decay=wd,
              learning_rate=0.1)
    want, _ = jlarc(**kw).update(
        {k: jnp.asarray(v) for k, v in grads.items()}, optax.EmptyState(),
        {k: jnp.asarray(v) for k, v in params.items()})
    got, _ = larc(**kw).update(
        {k: torch.from_numpy(v) for k, v in grads.items()}, None,
        {k: torch.from_numpy(v) for k, v in params.items()})
    for k in grads:
        _close(got[k].numpy(), want[k])
    np.testing.assert_array_equal(got["z"].numpy(), grads["z"])
    np.testing.assert_array_equal(got["g0"].numpy(), grads["g0"])
    assert got["a"].dtype == torch.float32
    with pytest.raises(ValueError):
        larc(clip=True)


def test_larc_keeps_the_gradient_dtype():
    params, grads = _tree(1)
    got, _ = larc(clip=False).update(
        {k: torch.from_numpy(v).to(torch.bfloat16) for k, v in
         grads.items()}, None,
        {k: torch.from_numpy(v) for k, v in params.items()})
    assert all(g.dtype == torch.bfloat16 for g in got.values())


def test_larc_class_over_fused_sgd_matches_jax_chain():
    params, _ = _tree(2)
    names = list(params)
    tparams = [torch.from_numpy(params[k].copy()).requires_grad_()
               for k in names]
    opt = LARC(FusedSGD(tparams, lr=0.1, momentum=0.9, weight_decay=1e-4),
               trust_coefficient=0.02, clip=True, eps=1e-8)
    chain = optax.chain(
        jlarc(0.02, True, 1e-8, weight_decay=1e-4, learning_rate=0.1),
        jfused_sgd(learning_rate=0.1, momentum=0.9, weight_decay=0.0))
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = chain.init(jp)
    for step in range(2):
        _, grads = _tree(10 + step)
        for p, k in zip(tparams, names):
            p.grad = torch.from_numpy(grads[k])
        opt.step()
        assert opt.param_groups[0]["weight_decay"] == 1e-4
        upd, jstate = chain.update({k: jnp.asarray(v) for k, v in
                                    grads.items()}, jstate, jp)
        jp = optax.apply_updates(jp, upd)
    for p, k in zip(tparams, names):
        _close(p.detach().numpy(), jp[k])
    # a list of gradients given to step, as JAX's class takes them
    _, grads = _tree(20)
    opt.step([torch.from_numpy(grads[k]) for k in names])
