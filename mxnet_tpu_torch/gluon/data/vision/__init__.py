"""gluon.data.vision of the port (ref: python/mxnet/gluon/data/vision/)."""
from . import transforms
from .datasets import (MNIST, FashionMNIST, CIFAR10, CIFAR100,
                       ImageRecordDataset, ImageFolderDataset)
