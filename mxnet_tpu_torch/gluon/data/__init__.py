"""gluon.data of the port (ref: python/mxnet/gluon/data/): datasets,
samplers, the DataLoader and the vision datasets and transforms."""
from . import vision
from .dataloader import DataLoader, default_batchify_fn
from .dataset import ArrayDataset, Dataset, RecordFileDataset, SimpleDataset
from .sampler import (BatchSampler, FixedBucketSampler, IntervalSampler,
                      RandomSampler, Sampler, SequentialSampler)
