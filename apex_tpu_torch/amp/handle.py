"""Loss-scaling helpers (counterpart of ``apex_tpu/amp/handle.py``).

:func:`value_and_scaled_grad` is the JAX grad-transformer in PyTorch's
idiom: it runs the loss function, backward on the scaled loss through
``torch.autograd.grad`` (no ``.grad`` is written), and unscales (K12 on
the card), returning the loss, the fp32 unscaled gradients and the
found-inf flag as a device bool. The scale update stays with
``AmpOptimizer.apply_gradients``. :func:`scale_loss`, the handles and
``init`` keep apex's legacy surface.
"""

import contextlib
import warnings

import torch


def scale_loss(loss, amp_optimizer, state, loss_id=0):
    """``loss`` in fp32 times the loss's current scale."""
    return amp_optimizer.scale_loss(loss, state, loss_id=loss_id)


def value_and_scaled_grad(loss_fn, amp_optimizer, loss_id=0, has_aux=False):
    """``f(params, amp_state, *args) -> (loss[, aux]), grads, found_inf``.

    ``loss_fn(params, *args)`` returns a scalar loss (or ``(loss, aux)``
    with ``has_aux``); ``params`` is a dict of the tensors to
    differentiate (a module's ``named_parameters()``). The gradients come
    back as a dict keyed like ``params``: fp32, unscaled, contiguous, and
    zero for a parameter the loss does not reach (as ``jax.grad`` gives).
    ``loss`` is detached."""

    def f(params, amp_state, *args):
        out = loss_fn(params, *args)
        loss = out[0] if has_aux else out
        scaled = amp_optimizer.scale_loss(loss, amp_state, loss_id=loss_id)
        names = list(params)
        grads = torch.autograd.grad(scaled, [params[n] for n in names],
                                    allow_unused=True)
        grads = {n: (torch.zeros_like(params[n]) if g is None
                     else g.contiguous())
                 for n, g in zip(names, grads)}
        unscaled, found_inf = amp_optimizer.unscale(grads, amp_state,
                                                    loss_id=loss_id)
        loss = loss.detach()
        if has_aux:
            return (loss, out[1]), unscaled, found_inf
        return loss, unscaled, found_inf

    return f


@contextlib.contextmanager
def disable_casts():
    from apex_tpu_torch.amp import policy as _policy

    with _policy.disable_casts():
        yield


class AmpHandle:
    """The legacy handle of ``amp.init()`` over an ``(amp_optimizer,
    state)`` pair: ``scale_loss`` yields the scaled loss; the caller runs
    backward and passes the gradients to ``apply_gradients``."""

    def __init__(self, amp_optimizer=None, state=None, enable_caching=True,
                 verbose=False):
        self._amp_optimizer = amp_optimizer
        self._state = state
        self._cache = {}
        self._enable_caching = enable_caching
        self._verbose = verbose
        self._is_active = True

    def is_active(self):
        return self._is_active

    @property
    def has_cache(self):
        return self._enable_caching

    @property
    def cache(self):
        return self._cache

    def remove_cache(self, param):
        if self._enable_caching and param in self._cache:
            del self._cache[param]

    @property
    def verbose(self):
        return self._verbose

    @property
    def state(self):
        return self._state

    def update_state(self, state):
        """Thread the latest ``AmpOptState`` into the handle (the dynamic
        scale lives there)."""
        self._state = state
        return state

    @contextlib.contextmanager
    def scale_loss(self, loss, optimizer=None, loss_id=0, state=None):
        if not self._is_active:
            yield loss
            return
        amp_opt = self._amp_optimizer
        if amp_opt is None and optimizer is not None and hasattr(
                optimizer, "scale_loss"):
            amp_opt = optimizer
        if amp_opt is None:
            raise RuntimeError(
                "AmpHandle has no amp optimizer: construct it as "
                "AmpHandle(amp_optimizer, state) or pass the wrapped "
                "optimizer to scale_loss — silently skipping loss "
                "scaling would underflow fp16 gradients")
        use_state = state if state is not None else self._state
        if use_state is None:
            raise RuntimeError(
                "AmpHandle has no amp state: pass state= or call "
                "update_state() with the state threaded through "
                "apply_gradients")
        yield scale_loss(loss, amp_opt, use_state, loss_id=loss_id)

    def wrap_optimizer(self, optimizer, num_loss=1):
        return optimizer

    def _clear_cache(self):
        self._cache.clear()

    @contextlib.contextmanager
    def _disable_casts(self):
        with disable_casts():
            yield

    def _deactivate(self):
        self._is_active = False


class NoOpHandle:
    """The disabled-amp handle."""

    has_cache = False
    verbose = False

    def is_active(self):
        return False

    @contextlib.contextmanager
    def scale_loss(self, loss, optimizer=None, loss_id=0, state=None):
        del optimizer, loss_id, state
        yield loss

    def wrap_optimizer(self, optimizer, num_loss=1):
        return optimizer

    @contextlib.contextmanager
    def _disable_casts(self):
        yield

    def _clear_cache(self):
        pass

    def _deactivate(self):
        pass


def init(enabled=True, loss_scale="dynamic", enable_caching=True,
         verbose=False, allow_banned=False):
    """The deprecated entry: a ``NoOpHandle`` when disabled, else a bare
    ``AmpHandle`` (thread the optimizer and state in with
    ``update_state`` / ``scale_loss(optimizer=...)``). ``loss_scale``
    other than "dynamic" warns: the scale lives in the state that
    ``amp.initialize``'s optimizer makes."""
    del allow_banned
    if loss_scale != "dynamic":
        warnings.warn(
            "amp.init(loss_scale=...) has no effect here: the loss scale "
            "lives in the optimizer state produced by amp.initialize "
            "(configure it there via LossScaler(loss_scale=...))",
            stacklevel=2)
    if not enabled:
        return NoOpHandle()
    return AmpHandle(enable_caching=enable_caching, verbose=verbose)
