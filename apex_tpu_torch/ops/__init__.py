"""Kernels of the port and their plain PyTorch versions (counterpart of
``apex_tpu.ops``): ``attention`` (packed prefill attention) and
``decode_attention`` (paged decode attention), each dispatching on the
tensor's device to its CUDA wrapper (``*_cuda``) or its plain version.
Importing this package builds nothing: a CUDA source compiles the first
time its wrapper launches (``_build.load``) or when a caller asks for it
(``_build.build``)."""
