"""Models of the examples (counterpart of ``apex_tpu.models``): the
ResNets of the ImageNet example. JAX's DCGAN is still to port."""

from apex_tpu_torch.models.resnet import (BasicBlock,  # noqa: F401
                                          BottleneckBlock, ResNet, resnet18,
                                          resnet50)
