"""Kernels of the port and their plain PyTorch versions (counterpart of
``apex_tpu.ops``): ``attention`` (attention forward and its split
backward, differentiable), ``decode_attention`` (paged decode attention,
over pages in the compute dtype or the int8 KV tier's codes),
``layer_norm`` (row layer norm, differentiable), ``xent`` (the fused LM
head, linear + cross entropy without logits, differentiable),
``softmax`` (fused scale + mask + softmax, differentiable),
``multi_tensor`` (scale, axpby and norms over lists of tensors; the
optimizers reach its Adam, LAMB and SGD kernels), ``batch_norm``
(batch norm over rows, synced or local, differentiable) and ``qmatmul``
(the int8-weight decode matmul), each
dispatching on the tensor's device to its CUDA wrappers (``*_cuda``) or
its plain version. Importing this package builds nothing: a CUDA source
compiles the first time its wrapper launches (``_build.load``) or when a
caller asks for it (``_build.build``)."""
