"""The examples' programs (counterpart of the JAX repository's
``examples/``): ``imagenet``, ResNet training under amp with DDP and
SyncBatchNorm."""
