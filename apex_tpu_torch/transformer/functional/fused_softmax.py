"""Fused scale + mask + softmax (counterpart of
``apex_tpu/transformer/functional/fused_softmax.py``, itself a port of
apex's ``transformer/functional/fused_softmax.py`` and the Megatron
softmax kernels).

What it keeps from the JAX module:

  * the numerics contract: on the kernel path softmax in fp32 for
    fp16/bf16 inputs with the scale applied after the fp32 upcast, the
    output cast back to the input dtype; masked positions exactly 0,
    and a fully masked row all zeros;
  * the dispatch predicate ``is_kernel_available`` and
    ``get_batch_per_block``, verbatim, so the two packages take the same
    branch for the same shapes;
  * the unfused fallback ``forward_torch_softmax`` (which synthesizes the
    causal mask when the caller passes none).

The port has no dispatch table. ``use_pallas=True`` (the default) takes
the kernel, :func:`apex_tpu_torch.ops.softmax.scaled_masked_softmax` (K10
forward and K11 backward on a CUDA tensor, or K10L/K11L above 4096 keys
through the generic variant; their plain versions on a CPU tensor),
wherever ``is_kernel_available`` holds; a mask the kernel does not take
(one that does not broadcast to the scores along their leading axes)
raises there rather than quietly taking the plain function. ``False``
pins the plain
function, :func:`apex_tpu_torch.ops.softmax.scaled_masked_softmax_reference`,
the kernel's own plain version. It is the same function either way: the
fused causal path ignores an explicit mask, as the JAX module's does, so
switching ``use_pallas`` never changes the numbers beyond rounding.
"""

import torch

from apex_tpu_torch.ops import softmax as _softmax
from apex_tpu_torch.transformer.enums import AttnMaskType


def _causal(sq, sk, device):
    return (torch.arange(sk, device=device)[None, :]
            > torch.arange(sq, device=device)[:, None])


def scaled_upper_triang_masked_softmax(x, scale=1.0):
    """Causal-masked scaled softmax; ``x``: ``[attn_batches, sq, sk]``
    with sq == sk."""
    return _softmax.scaled_masked_softmax_reference(x, None, scale, True)


def scaled_masked_softmax(x, mask, scale=1.0):
    """Explicit-mask scaled softmax; ``x``: ``[b, np, sq, sk]``; ``mask``
    bool broadcastable to x, True = masked out."""
    return _softmax.scaled_masked_softmax_reference(x, mask, scale, False)


def generic_scaled_masked_softmax(x, mask, scale=1.0):
    """The arbitrary-length variant: the same function as
    :func:`scaled_masked_softmax`."""
    return scaled_masked_softmax(x, mask, scale)


class FusedScaleMaskSoftmax:
    """Fused operation: scaling + mask + softmax.

    Arguments keep the reference names: ``input_in_fp16``/``input_in_bf16``
    describe the incoming activation dtype, ``attn_mask_type`` selects the
    causal kernel, ``scaled_masked_softmax_fusion`` enables the fused path,
    ``mask_func`` is the fallback's mask application, ``softmax_in_fp32``
    upcasts on the fallback path, ``scale`` pre-scales the logits (only
    with ``softmax_in_fp32``), ``use_pallas`` as in the module docstring.
    """

    def __init__(self, input_in_fp16, input_in_bf16, attn_mask_type,
                 scaled_masked_softmax_fusion, mask_func, softmax_in_fp32,
                 scale, use_pallas=True):
        self.input_in_fp16 = input_in_fp16
        self.input_in_bf16 = input_in_bf16
        assert not (input_in_fp16 and input_in_bf16), \
            "both fp16 and bf16 flags cannot be active at the same time."
        self.input_in_float16 = input_in_fp16 or input_in_bf16
        self.attn_mask_type = attn_mask_type
        self.scaled_masked_softmax_fusion = scaled_masked_softmax_fusion
        self.mask_func = mask_func
        self.softmax_in_fp32 = softmax_in_fp32
        self.scale = scale
        if not isinstance(use_pallas, bool):
            raise ValueError(f"use_pallas must be True or False, got "
                             f"{use_pallas!r}")
        self.use_pallas = use_pallas
        assert self.scale is None or softmax_in_fp32, \
            "softmax should be in fp32 when scaled"

    def __call__(self, input, mask):
        assert input.dim() == 4  # [b, np, sq, sk]
        if self.is_kernel_available(mask, *input.shape):
            return self.forward_fused_softmax(input, mask)
        return self.forward_torch_softmax(input, mask)

    def is_kernel_available(self, mask, b, np_, sq, sk):
        """The reference's dispatch predicate (its shape limits came from
        the CUDA kernels' templated launch bounds), verbatim."""
        attn_batches = b * np_
        if (self.scaled_masked_softmax_fusion
                and self.input_in_float16
                and 16 < sk <= 4096
                and sq % 4 == 0
                and attn_batches % 4 == 0):
            batch_per_block = self.get_batch_per_block(sq, sk, b, np_)
            if self.attn_mask_type == AttnMaskType.causal:
                if attn_batches % batch_per_block == 0:
                    return True
            else:
                if sq % batch_per_block == 0:
                    return True
        return False

    def forward_fused_softmax(self, input, mask):
        scale = self.scale if self.scale is not None else 1.0
        causal = self.attn_mask_type == AttnMaskType.causal
        if causal:
            assert input.shape[-2] == input.shape[-1], \
                "causal mask is only for self attention"
            # the fused causal path ignores an explicit mask (the
            # reference's scaled_upper_triang kernel takes none) — pass
            # None so toggling use_pallas never changes numerics
            mask = None
        if self.use_pallas:
            return _softmax.scaled_masked_softmax(input, mask, scale,
                                                  causal=causal)
        return _softmax.scaled_masked_softmax_reference(input, mask, scale,
                                                        causal)

    def forward_torch_softmax(self, input, mask):
        """The unfused fallback. The causal case masks even when the caller
        passes ``mask=None`` (the fused causal kernel never takes an
        explicit mask, so causal models pass None): the fallback
        synthesizes the triangle, keeping fused and unfused
        interchangeable."""
        if self.attn_mask_type == AttnMaskType.causal:
            sq, sk = input.shape[-2], input.shape[-1]
            causal = _causal(sq, sk, input.device)
            mask = causal if mask is None else (mask.bool() | causal)
        orig_dtype = input.dtype
        if self.input_in_float16 and self.softmax_in_fp32:
            input = input.float()
        if self.scale is not None:
            input = input * self.scale
        mask_output = self.mask_func(input, mask) if mask is not None \
            else input
        m = mask_output.amax(dim=-1, keepdim=True)
        e = torch.exp(mask_output - m)
        probs = e / e.sum(dim=-1, keepdim=True)
        if self.input_in_float16 and self.softmax_in_fp32:
            probs = probs.to(orig_dtype)
        return probs

    @staticmethod
    def get_batch_per_block(sq, sk, b, np_):
        """The reference's launch-geometry shim (batches per 128-thread
        block given next_pow2(sk)); it only feeds the dispatch
        predicate."""
        pow2 = 1 << (sk - 1).bit_length()
        warp_size = pow2 if pow2 <= 32 else 32
        batches_per_warp = 2 if pow2 <= 128 else 1
        warps_per_block = 128 // warp_size
        return warps_per_block * batches_per_warp


class GenericFusedScaleMaskSoftmax(FusedScaleMaskSoftmax):
    """The generic variant: the kernel branch needs only the fusion flag
    and a half dtype, and takes any length (K10/K11 up to 4096 keys,
    K10L/K11L above), as the JAX variant serves any length."""

    def __init__(self, input_in_fp16, input_in_bf16, mask_func,
                 softmax_in_fp32, scale, use_pallas=True):
        super().__init__(input_in_fp16, input_in_bf16, AttnMaskType.padding,
                         True, mask_func, softmax_in_fp32, scale,
                         use_pallas=use_pallas)

    def is_kernel_available(self, mask, b, np_, sq, sk):
        return self.scaled_masked_softmax_fusion and self.input_in_float16


class ScaledUpperTriangMaskedSoftmax:
    """``ScaledUpperTriangMaskedSoftmax.apply(x, scale)``: autograd runs
    through the function; the class exists so ported call sites run."""

    @staticmethod
    def apply(x, scale=1.0):
        return scaled_upper_triang_masked_softmax(x, scale)


class ScaledMaskedSoftmax:
    """``ScaledMaskedSoftmax.apply(x, mask, scale)``."""

    @staticmethod
    def apply(x, mask, scale=1.0):
        return scaled_masked_softmax(x, mask, scale)


class GenericScaledMaskedSoftmax:
    """``GenericScaledMaskedSoftmax.apply(x, mask, scale)``."""

    @staticmethod
    def apply(x, mask, scale=1.0):
        return generic_scaled_masked_softmax(x, mask, scale)
