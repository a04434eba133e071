"""Fused linear + cross entropy, the LM head without logits (counterpart
of ``apex_tpu/ops/xent_pallas.py``).

* :func:`supported` decides, as ``xent_pallas.supported`` does, whether
  the fused head takes ``x [n, h] x E [V, h]``: V has a multiple-of-128
  divisor of at most 512, h is a multiple of 128, and some power-of-two
  row block of at least 8 divides n under the JAX package's VMEM model
  (``apex_tpu/dispatch/tiles.py:379-411``, an 8 MiB budget). It only
  picks the branch, so that both packages take the same one for one
  configuration; the CUDA kernels have their own tiling and take more.
* :func:`linear_cross_entropy_fwd`, :func:`linear_cross_entropy_dx` and
  :func:`linear_cross_entropy_de` are the plain versions of the three
  TPU kernels (``_fwd_kernel :184``, ``_dx_kernel :222``, ``_de_kernel
  :246``). Each walks the vocabulary in chunks, so none holds ``[n, V]``
  logits, and each rounds where the TPU kernel rounds: fp32 logits of the
  inputs, fp32 online (max, sum of exponentials), ``coeff`` rounded to
  E's dtype for dX and to x's dtype for dE, ``dl * x`` rounded to x's
  dtype, fp32 accumulation of both gradient products.
* :func:`linear_cross_entropy` is the ``torch.autograd.Function`` around
  them; its forward saves ``(x, E, labels, lse)`` as ``_fwd :440`` does.
  For a CUDA tensor it runs K7 forward and K8 (dX) and K9 (dE) backward
  (:mod:`apex_tpu_torch.ops.xent_cuda`); for a CPU tensor the plain
  versions. There is no fallback from one to the other.
* :func:`linear_cross_entropy_partials` is the plain version of the
  vocabulary-shard forward ``_fwd_partial_kernel :203`` (K7p on the
  card): per-row fp32 (max, sum of exponentials, target, logits sum).
* :func:`linear_cross_entropy_sharded` is the tensor-parallel head
  (``_fwd_sharded :321``, ``_bwd_sharded_rule :373``): each rank holds a
  shard of E, its partials are combined over the tp group with
  ``torch.distributed`` (MAX of the maxima, SUM of the rescaled sums and
  of the targets), the backward is K8/K9's function on the shard with the
  global lse and ``v_total = Vs * tp``, dX summed over the group.

Label smoothing has contrib-xentropy semantics: ``(1 - eps) * nll + eps
* (lse - mean logits)``. The TPU tile knobs (row-block preference,
``set_row_block``, ``APEX_XENT_ROW_BLOCK``, ``vmem_budget``) model TPU
VMEM and have no counterpart here.
"""

import torch
import torch.distributed as dist

from apex_tpu_torch.ops import xent_cuda

# the JAX package's branch predicate (apex_tpu/dispatch/tiles.py)
_VMEM_BUDGET = 8 * 1024 * 1024
_MAX_VCHUNK = 512
_ROW_CAP = 512
_LANE = 128
_SUBLANE = 8

# vocabulary rows per step of the plain versions
_CHUNK = 4096


def _v_chunk(V):
    for bv in range(_MAX_VCHUNK, 0, -_LANE):
        if V % bv == 0:
            return bv
    return 0


def _row_block(n, h, bv):
    fixed = 6 * bv * h
    if fixed >= _VMEM_BUDGET:
        return 0
    per_row = max(8 * h + 8 * bv, 6 * h + 10 * bv)
    lim = min(_ROW_CAP, (_VMEM_BUDGET - fixed) // per_row)
    b, best = _SUBLANE, 0
    while b <= lim:
        if n % b == 0:
            best = b
        b *= 2
    return best


def supported(n, V, h):
    """Whether the fused head handles X [n, h] x E [V, h]."""
    bv = _v_chunk(V)
    return bv != 0 and h % _LANE == 0 and _row_block(n, h, bv) != 0


def _chunks(V):
    for v0 in range(0, V, _CHUNK):
        yield v0, min(V, v0 + _CHUNK)


def _logits(x, e_chunk):
    return torch.matmul(x.float(), e_chunk.float().t())


def _coeff(logits, lse, labels, v0, v_total, eps):
    """``softmax - (1 - eps) onehot - eps / v_total`` of one chunk, fp32."""
    cols = torch.arange(v0, v0 + logits.shape[1], device=logits.device)
    hit = (cols[None, :] == labels[:, None]).float()
    return (torch.exp(logits - lse[:, None]) - (1.0 - eps) * hit
            - eps / v_total)


def linear_cross_entropy_partials(x, e, labels, smoothing=0.0):
    """``(m, s, t, u)``, each fp32 ``[n]``, over the rows of E ``[V, h]``
    (a whole table or one rank's shard, with ``labels`` local to it): the
    row max of the logits, the sum of their exponentials at that max, the
    target logit (0 where the label is outside ``[0, V)``) and, with
    smoothing, the logits' sum (else 0)."""
    n, V = x.shape[0], e.shape[0]
    labels = labels.long()
    m = torch.full((n,), float("-inf"), device=x.device)
    s = torch.zeros(n, device=x.device)
    t = torch.zeros(n, device=x.device)
    u = torch.zeros(n, device=x.device)
    for v0, v1 in _chunks(V):
        logits = _logits(x, e[v0:v1])
        m_new = torch.maximum(m, logits.amax(dim=1))
        s = s * torch.exp(m - m_new) + torch.exp(
            logits - m_new[:, None]).sum(dim=1)
        m = m_new
        local = labels - v0
        hit = (local >= 0) & (local < v1 - v0)
        target = logits.gather(1, local.clamp(0, v1 - v0 - 1)[:, None])[:, 0]
        t = t + torch.where(hit, target, 0.0)
        if smoothing:
            u = u + logits.sum(dim=1)
    return m, s, t, u


def linear_cross_entropy_fwd(x, e, labels, smoothing=0.0):
    """``(loss, lse)``, fp32 ``[n]``, for x ``[n, h]``, E ``[V, h]`` and
    integer labels ``[n]`` (a label outside ``[0, V)`` has no target)."""
    m, s, t, u = linear_cross_entropy_partials(x, e, labels, smoothing)
    lse = m + torch.log(s)
    if smoothing:
        return lse - (1.0 - smoothing) * t - smoothing * u / e.shape[0], lse
    return lse - t, lse


def linear_cross_entropy_dx(x, e, labels, lse, dl, smoothing=0.0,
                            v_total=None):
    """dX ``[n, h]`` in x's dtype for the fp32 cotangent ``dl [n]``; the
    uniform smoothing term divides by ``v_total`` (None: E's rows)."""
    labels = labels.long()
    V = e.shape[0]
    v_total = V if v_total is None else v_total
    acc = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for v0, v1 in _chunks(V):
        coeff = _coeff(_logits(x, e[v0:v1]), lse, labels, v0, v_total,
                       smoothing)
        acc += torch.matmul(coeff.to(e.dtype).float(), e[v0:v1].float())
    return (dl.float()[:, None] * acc).to(x.dtype)


def linear_cross_entropy_de(x, e, labels, lse, dl, smoothing=0.0,
                            v_total=None):
    """dE ``[V, h]`` in E's dtype for the fp32 cotangent ``dl [n]``
    (``v_total`` as for dX)."""
    labels = labels.long()
    V = e.shape[0]
    v_total = V if v_total is None else v_total
    wx = (dl.float()[:, None] * x.float()).to(x.dtype).float()
    de = torch.empty_like(e)
    for v0, v1 in _chunks(V):
        coeff = _coeff(_logits(x, e[v0:v1]), lse, labels, v0, v_total,
                       smoothing)
        de[v0:v1] = torch.matmul(coeff.to(x.dtype).float().t(), wx).to(
            e.dtype)
    return de


class _LinearCrossEntropy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, e, labels, smoothing):
        if x.is_cuda:
            labels = labels.to(torch.int32).contiguous()
            loss, lse = xent_cuda.xent_fwd(x, e, labels, smoothing)
        elif x.device.type == "cpu":
            loss, lse = linear_cross_entropy_fwd(x, e, labels, smoothing)
        else:
            raise ValueError(f"linear_cross_entropy: no kernel for device "
                             f"{x.device}")
        ctx.save_for_backward(x, e, labels, lse)
        ctx.smoothing = smoothing
        return loss

    @staticmethod
    def backward(ctx, g):
        x, e, labels, lse = ctx.saved_tensors
        dl = g.float().contiguous()
        eps = ctx.smoothing
        if x.is_cuda:
            dx_fn, de_fn = xent_cuda.xent_bwd_dx, xent_cuda.xent_bwd_de
        else:
            dx_fn, de_fn = linear_cross_entropy_dx, linear_cross_entropy_de
        dx = (dx_fn(x, e, labels, lse, dl, eps)
              if ctx.needs_input_grad[0] else None)
        de = (de_fn(x, e, labels, lse, dl, eps)
              if ctx.needs_input_grad[1] else None)
        return dx, de, None, None


def linear_cross_entropy(x, embedding, labels, smoothing=0.0):
    """Fused ``-log_softmax(x @ embedding^T)[i, labels[i]]`` -> fp32
    ``[n]``, differentiable in x ``[n, h]`` and the embedding ``[V, h]``
    (one dtype); the ``[n, V]`` logits are never materialized. Check
    :func:`supported` first, as the JAX package's callers do."""
    return _LinearCrossEntropy.apply(x.contiguous(), embedding.contiguous(),
                                     labels.reshape(-1), float(smoothing))


class _LinearCrossEntropySharded(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, e_shard, labels, group, smoothing, reduce_dx):
        rank, tp = dist.get_rank(group), dist.get_world_size(group)
        v_shard = e_shard.shape[0]
        local = labels - rank * v_shard        # off the shard: no target
        if x.is_cuda:
            local = local.to(torch.int32).contiguous()
            m, s, t, u = xent_cuda.xent_fwd_partials(x, e_shard, local,
                                                     smoothing)
        elif x.device.type == "cpu":
            m, s, t, u = linear_cross_entropy_partials(x, e_shard, local,
                                                       smoothing)
        else:
            raise ValueError(f"linear_cross_entropy_sharded: no kernel for "
                             f"device {x.device}")
        # the cross-rank combine of _fwd_sharded :350-361
        m_g = m.clone()
        dist.all_reduce(m_g, op=dist.ReduceOp.MAX, group=group)
        l_g = s * torch.exp(m - m_g)
        dist.all_reduce(l_g, group=group)
        t_g = t
        dist.all_reduce(t_g, group=group)
        lse = m_g + torch.log(l_g)
        v_total = v_shard * tp
        if smoothing:
            u_g = u
            dist.all_reduce(u_g, group=group)
            # divided by a tensor on x's device (on the card PyTorch turns
            # a division by a host scalar into a reciprocal multiply)
            vt = torch.full((), float(v_total), device=x.device)
            loss = lse - (1.0 - smoothing) * t_g - smoothing * u_g / vt
        else:
            loss = lse - t_g
        ctx.save_for_backward(x, e_shard, local, lse)
        ctx.group, ctx.smoothing, ctx.reduce_dx = group, smoothing, reduce_dx
        ctx.v_total = v_total
        return loss

    @staticmethod
    def backward(ctx, g):
        x, e_shard, local, lse = ctx.saved_tensors
        dl = g.float().contiguous()
        eps, v_total = ctx.smoothing, ctx.v_total
        if x.is_cuda:
            dx_fn, de_fn = xent_cuda.xent_bwd_dx, xent_cuda.xent_bwd_de
        else:
            dx_fn, de_fn = linear_cross_entropy_dx, linear_cross_entropy_de
        dx = de = None
        if ctx.needs_input_grad[0]:
            dx = dx_fn(x, e_shard, local, lse, dl, eps, v_total)
            if ctx.reduce_dx:
                dist.all_reduce(dx, group=ctx.group)
        if ctx.needs_input_grad[1]:
            de = de_fn(x, e_shard, local, lse, dl, eps, v_total)
        return dx, de, None, None, None, None


def linear_cross_entropy_sharded(x, e_shard, labels, group, smoothing=0.0,
                                 reduce_dx=True):
    """The vocab-parallel fused head: fp32 ``[n]`` losses of x ``[n, h]``
    (the same on every rank of ``group``) against the global ``labels
    [n]``, this rank holding rows ``[rank Vs, (rank + 1) Vs)`` of the
    embedding as ``e_shard [Vs, h]`` (x's dtype); differentiable in x and
    the shard. dX is summed over the group unless ``reduce_dx=False`` (a
    caller whose own mapping sums it); dE stays local. Check
    :func:`supported` on the shard's shape first, as the JAX package's
    callers do."""
    return _LinearCrossEntropySharded.apply(
        x.contiguous(), e_shard.contiguous(), labels.reshape(-1).long(),
        group, float(smoothing), bool(reduce_dx))
