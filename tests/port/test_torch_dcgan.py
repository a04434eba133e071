"""Port parity of the DCGAN example (BASELINE config 5):
``apex_tpu_torch.models.dcgan`` and ``apex_tpu_torch.examples.dcgan``
against ``apex_tpu.models`` and the JAX step that ``examples/dcgan/
main_amp.py:72-124`` builds, on the same flax init and numpy-seeded data.

* the flax -> torch converter and its inverse give the tree back bit for
  bit;
* G and D forward passes in train and eval mode agree within 1e-5, and a
  train pass moves the running stats as flax's (momentum 0.99, biased
  variance);
* three steps of the three-loss step (ngf = ndf = 8, b = 4, 64^2) at O1
  and O2, each from JAX's state after the step before (parameters,
  masters, running stats, Adam moments and count, scalers, all loaded
  into the port): the losses, both models' parameters (and masters under
  O2) and running stats, and all six scalers within 1e-5;
* a step with an overflow forced on loss 0 only (an inf pixel in the real
  batch: loss 0 and its gradients are not finite, loss 1's are): D is
  skipped, scaler 0 halved, scaler 1 advanced from its own flag, G
  stepped; D's running stats turn NaN in both packages, as they must.

Tolerances: each value held within 1e-5 absolute (the weights are O(0.1),
the Adam steps 2e-4, the losses O(1)); the two packages sum the
convolutions and the batch-norm statistics in other orders, which moves a
gradient by ~1e-7 relative. Two places where that noise is amplified by
design get a band of their own, each stated where it is used: Adam's
early steps move an element by ~lr whatever its gradient's size, so an
element whose JAX gradient is within noise of zero (at most 1e-5 of its
tensor's largest) may move the other way, and is held within the most
Adam can move it in a step, 2 lr (at most 0.1% of the elements may take
that band; one element of 43 K does at step 1); and under O2 a bf16
parameter is its master rounded, so it is held within one bf16 ulp of
JAX's on top. Each step starts from JAX's state, so such a flip does not
carry into the next step's losses.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from apex_tpu import amp as jamp
from apex_tpu.models import Discriminator as JD
from apex_tpu.models import Generator as JG
from apex_tpu_torch.examples import dcgan as tex
from apex_tpu_torch.models import Discriminator as TD
from apex_tpu_torch.models import Generator as TG
from apex_tpu_torch.serving.weights import dcgan_to_jax, load_dcgan_from_jax

torch.set_num_threads(2)

NZ, NGF, NDF, B, ISIZE = 100, 8, 8, 4, 64
LR, BETA1 = 2e-4, 0.5
TOL = 1e-5


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        name = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_flat(v, name))
        else:
            out[name] = np.asarray(v, np.float32)
    return out


@pytest.fixture(scope="module")
def flax_vars():
    key = jax.random.PRNGKey(0)
    vG = JG(nz=NZ, ngf=NGF).init(key, jnp.zeros((B, 1, 1, NZ)), train=False)
    vD = JD(ndf=NDF).init(key, jnp.zeros((B, ISIZE, ISIZE, 3)), train=False)
    return jax.tree_util.tree_map(np.asarray, (dict(vG), dict(vD)))


def _port(flax_vars, stats=None):
    (vG, vD) = flax_vars
    sG, sD = stats or (vG["batch_stats"], vD["batch_stats"])
    netG = load_dcgan_from_jax(TG(nz=NZ, ngf=NGF, device="cpu"),
                               vG["params"], sG)
    netD = load_dcgan_from_jax(TD(ndf=NDF, device="cpu"), vD["params"], sD)
    return netG, netD


def _random_stats(stats, seed):
    rs = np.random.RandomState(seed)
    return {m: {"mean": rs.randn(*v["mean"].shape).astype(np.float32) * 0.1,
                "var": rs.uniform(0.5, 1.5, v["var"].shape).astype(
                    np.float32)}
            for m, v in stats.items()}


def test_converter_round_trip(flax_vars):
    netG, netD = _port(flax_vars)
    for net, v in zip((netG, netD), flax_vars):
        params, stats = dcgan_to_jax(net)
        for got, want in ((params, v["params"]), (stats, v["batch_stats"])):
            got, want = _flat(got), _flat(want)
            assert got.keys() == want.keys()
            for k in want:
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_forward_and_running_stats_match_flax(flax_vars, train):
    vG, vD = flax_vars
    sG = _random_stats(vG["batch_stats"], 1)
    sD = _random_stats(vD["batch_stats"], 2)
    netG, netD = _port(flax_vars, (sG, sD))
    rs = np.random.RandomState(3)
    z = rs.randn(B, 1, 1, NZ).astype(np.float32)
    x = (rs.rand(B, ISIZE, ISIZE, 3) * 2 - 1).astype(np.float32)
    for jm, net, v, s, inp in ((JG(nz=NZ, ngf=NGF), netG, vG, sG, z),
                               (JD(ndf=NDF), netD, vD, sD, x)):
        variables = {"params": v["params"], "batch_stats": s}
        if train:
            want, new = jm.apply(variables, inp, train=True,
                                 mutable=["batch_stats"])
        else:
            want, new = jm.apply(variables, inp, train=False), {
                "batch_stats": s}
        got = net(torch.from_numpy(inp), train=train)
        assert tuple(got.shape) == want.shape
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   atol=TOL, rtol=0)
        got_stats = _flat(dcgan_to_jax(net)[1])
        for k, w in _flat(new["batch_stats"]).items():
            np.testing.assert_allclose(got_stats[k], w, atol=1e-6, rtol=0,
                                       err_msg=k)
        if train:   # flax's convention moved them
            assert any(np.abs(got_stats[k] - v).max() > 1e-4
                       for k, v in _flat(s).items())


def _jax_step(netG, netD, optG, optD):
    """The JAX example's train step (main_amp.py:72-124), built as it
    builds it."""
    def bce(logits, target):
        return jnp.mean(optax.sigmoid_binary_cross_entropy(
            logits.astype(jnp.float32), jnp.full(logits.shape, target)))

    @jax.jit
    def train_step(pG, sG, stG, pD, sD, stD, real, z):
        def d_loss_real(p):
            out, newv = netD.apply({"params": p, "batch_stats": sD}, real,
                                   train=True, mutable=["batch_stats"])
            return bce(out, 1.0), newv["batch_stats"]

        (lossD_real, sD1), g0, inf0 = jamp.value_and_scaled_grad(
            d_loss_real, optD, loss_id=0, has_aux=True)(pD, stD)

        def d_loss_fake(p, fake):
            out, newv = netD.apply({"params": p, "batch_stats": sD1}, fake,
                                   train=True, mutable=["batch_stats"])
            return bce(out, 0.0), newv["batch_stats"]

        fake, newsG = netG.apply({"params": pG, "batch_stats": sG}, z,
                                 train=True, mutable=["batch_stats"])
        newsG = newsG["batch_stats"]
        (lossD_fake, sD2), g1, inf1 = jamp.value_and_scaled_grad(
            lambda p: d_loss_fake(p, jax.lax.stop_gradient(fake)), optD,
            loss_id=1, has_aux=True)(pD, stD)
        gD = jax.tree_util.tree_map(jnp.add, g0, g1)
        stD = optD.update_scaler(stD, inf1, loss_id=1)
        pD, stD, _ = optD.apply_gradients(
            gD, stD, pD, loss_id=0, grads_already_unscaled=True,
            found_inf=inf0 | inf1, scaler_found_inf=inf0)

        def g_loss(p):
            fake, newv = netG.apply({"params": p, "batch_stats": newsG}, z,
                                    train=True, mutable=["batch_stats"])
            out, _ = netD.apply({"params": pD, "batch_stats": sD2}, fake,
                                train=True, mutable=["batch_stats"])
            return bce(out, 1.0), newv["batch_stats"]

        (lossG, newsG2), gG, inf2 = jamp.value_and_scaled_grad(
            g_loss, optG, loss_id=2, has_aux=True)(pG, stG)
        pG, stG, _ = optG.apply_gradients(
            gG, stG, pG, loss_id=2, grads_already_unscaled=True,
            found_inf=inf2)
        return (pG, newsG2, stG, pD, sD2, stD,
                jnp.stack([lossD_real + lossD_fake, lossG]), gG, gD)

    return train_step


def _scalers(jst, tst):
    """Each scaler as (scale, unskipped) in both packages."""
    return ([(float(s.loss_scale), int(s.unskipped)) for s in jst.scalers],
            [(s.loss_scale.item(), s.unskipped.item()) for s in tst.scalers])


def _bf16_ulp(a):
    """One bf16 ulp at each element's magnitude."""
    e = np.floor(np.log2(np.maximum(np.abs(a), 2.0 ** -126)))
    return 2.0 ** (e - 7)


def _assert_close_tree(got, want, what, tiny=None, ulp=False):
    """Each element within TOL; where ``tiny`` flags it (a JAX gradient
    within noise of zero), within an Adam step's 2 lr more; with ``ulp``,
    one bf16 ulp more."""
    got, want = _flat(got), _flat(want)
    assert got.keys() == want.keys(), what
    for k in want:
        band = np.full(want[k].shape, TOL)
        if tiny is not None:
            band = np.where(tiny[k], TOL + 2 * LR, band)
        if ulp:
            band = band + _bf16_ulp(want[k])
        both_nan = np.isnan(got[k]) & np.isnan(want[k])
        err = np.where(both_nan, 0.0, np.abs(got[k] - want[k]))
        assert (err <= band).all(), (
            f"{what} {k}: {int((err > band).sum())} of {err.size} elements "
            f"outside the band, worst {float((err - band).max()):.3g} over")


def _tiny_grads(grads):
    """The elements of a JAX gradient tree within noise of zero: at most
    1e-5 of their tensor's largest magnitude."""
    return {k: np.abs(g) <= 1e-5 * np.abs(g).max()
            for k, g in _flat(grads).items()}


def _port_named(tree, net):
    """A flax-named tree of parameter-shaped arrays (Adam moments,
    masters) keyed by the port's names, converted as the parameters are."""
    import copy

    shadow = copy.deepcopy(net).float()
    load_dcgan_from_jax(shadow, tree)
    return {n: p.detach() for n, p in shadow.named_parameters()}


@torch.no_grad()
def _sync(net, tst, p, s, jst):
    """Load JAX's state after a step into the port: the model's parameters
    and running stats, the masters, Adam's moments and count, the
    scalers."""
    load_dcgan_from_jax(net, p, s)
    adam = jst.inner[0]
    tst.inner.count.fill_(int(adam.count))
    for dst, tree in ((tst.inner.m, adam.mu), (tst.inner.v, adam.nu)) + (
            ((tst.master_params, jst.master_params),)
            if jst.master_params is not None else ()):
        for n, t in _port_named(tree, net).items():
            dst[n].copy_(t)
    for ts, js in zip(tst.scalers, jst.scalers):
        ts.loss_scale.fill_(float(js.loss_scale))
        ts.unskipped.fill_(int(js.unskipped))


def _masters(st):
    return {n: t.numpy() for n, t in st.master_params.items()}


def _run(flax_vars, level, steps, force_overflow=False):
    vG, vD = flax_vars
    jG, jD = JG(nz=NZ, ngf=NGF), JD(ndf=NDF)
    pG, optG = jamp.initialize(vG["params"], optax.adam(LR, b1=BETA1),
                               opt_level=level, num_losses=3, verbosity=0)
    pD, optD = jamp.initialize(vD["params"], optax.adam(LR, b1=BETA1),
                               opt_level=level, num_losses=3, verbosity=0)
    stG, stD = optG.init(pG), optD.init(pD)
    sG, sD = vG["batch_stats"], vD["batch_stats"]
    jstep = _jax_step(jG, jD, optG, optD)

    class Args:
        nz, ngf, ndf, lr, beta1, opt_level = NZ, NGF, NDF, LR, BETA1, level
    netG, netD, toptG, toptD = tex.build_models(Args, "cpu")
    load_dcgan_from_jax(netG, vG["params"], sG)
    load_dcgan_from_jax(netD, vD["params"], sD)
    for net, p in ((netG, pG), (netD, pD)):     # JAX's O2 cast plan
        got = dcgan_to_jax_dtypes(net)
        want = {k: str(np.asarray(a).dtype) for k, a in _flat_raw(p).items()}
        assert got == want
    tstG = toptG.init(dict(netG.named_parameters()))
    tstD = toptD.init(dict(netD.named_parameters()))
    tstep = tex.build_train_step(netG, netD, toptG, toptD)
    rs = np.random.RandomState(0)
    out = []
    for i in range(steps):
        real = (rs.rand(B, ISIZE, ISIZE, 3) * 2 - 1).astype(np.float32)
        z = rs.randn(B, 1, 1, NZ).astype(np.float32)
        if force_overflow:
            real[0, 0, 0, 0] = np.inf
        pG, sG, stG, pD, sD, stD, jl, gG, gD = jstep(
            pG, sG, stG, pD, sD, stD, jnp.asarray(real), jnp.asarray(z))
        tiny = {"G": _tiny_grads(gG), "D": _tiny_grads(gD)}
        flagged = sum(int(t.sum()) for d in tiny.values() for t in d.values())
        total = sum(t.size for d in tiny.values() for t in d.values())
        assert flagged <= 1e-3 * total, (flagged, total)
        tstG, tstD, tl = tstep(tstG, tstD, torch.from_numpy(real),
                               torch.from_numpy(z))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL,
                                   rtol=0, equal_nan=True)
        for net, p, s, jst, tst, what in (
                (netG, pG, sG, stG, tstG, "G"), (netD, pD, sD, stD, tstD,
                                                  "D")):
            tp, ts = dcgan_to_jax(net)
            _assert_close_tree(tp, p, f"{what} params", tiny[what],
                               ulp=level == "O2")
            _assert_close_tree(ts, s, f"{what} stats")
            if jst.master_params is not None:
                _assert_close_tree(_jax_named(_masters(tst), net),
                                   jst.master_params, f"{what} masters",
                                   tiny[what])
            js, ts_ = _scalers(jst, tst)
            assert ts_ == js, f"{what} scalers"
        out.append((_scalers(stG, tstG), _scalers(stD, tstD)))
        if i + 1 < steps:
            _sync(netG, tstG, pG, sG, stG)
            _sync(netD, tstD, pD, sD, stD)
    return out, (vG, vD), (netG, netD)


def _flat_raw(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        name = f"{prefix}/{k}" if prefix else k
        out.update(_flat_raw(v, name) if isinstance(v, dict) else {name: v})
    return out


def dcgan_to_jax_dtypes(net):
    """The port's parameter dtypes under flax's flat names."""
    names = {"weight": "scale", "bias": "bias"}
    out = {}
    for name, p in net.named_parameters():
        mod, leaf = name.split(".")
        key = names[leaf] if mod.startswith("bn") else "kernel"
        out[f"{mod}/{key}"] = str(p.dtype).replace("torch.", "")
    return out


def _jax_named(masters, net):
    """Masters keyed by the port's names, as a flax tree (converted like
    the model's parameters)."""
    import copy

    shadow = copy.deepcopy(net).float()
    with torch.no_grad():
        for n, p in shadow.named_parameters():
            p.copy_(torch.from_numpy(masters[n]))
    return dcgan_to_jax(shadow)[0]


@pytest.mark.parametrize("level", ["O1", "O2"])
def test_three_loss_step_matches_jax(flax_vars, level):
    scalers, _, _ = _run(flax_vars, level, steps=3)
    (g, _), (d, _) = scalers[-1]
    assert [u for _, u in g] == [0, 0, 3] and [u for _, u in d] == [3, 3, 0]


def test_overflow_on_loss_zero_skips_d_only(flax_vars):
    scalers, (vG, vD), (netG, netD) = _run(flax_vars, "O1", steps=1,
                                           force_overflow=True)
    (g, _), (d, _) = scalers[0]
    assert d[0] == (2.0 ** 15, 0)       # halved
    assert d[1] == (2.0 ** 16, 1)       # advanced from its own flag
    assert d[2] == (2.0 ** 16, 0)       # loss 2 is G's
    assert g[2] == (2.0 ** 16, 1)
    tp, _ = dcgan_to_jax(netD)
    for k, w in _flat(vD["params"]).items():      # D skipped
        np.testing.assert_array_equal(_flat(tp)[k], w, err_msg=k)
    tg, _ = dcgan_to_jax(netG)
    assert any(np.abs(_flat(tg)[k] - w).max() > 0
               for k, w in _flat(vG["params"]).items())
