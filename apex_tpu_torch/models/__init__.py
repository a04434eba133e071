"""Models of the examples (counterpart of ``apex_tpu.models``): the
ResNets of the ImageNet example and the DCGAN of the amp multi-loss
example."""

from apex_tpu_torch.models.dcgan import Discriminator, Generator  # noqa: F401
from apex_tpu_torch.models.resnet import (BasicBlock,  # noqa: F401
                                          BottleneckBlock, ResNet, resnet18,
                                          resnet50)
