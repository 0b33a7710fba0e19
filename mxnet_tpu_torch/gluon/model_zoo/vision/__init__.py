"""gluon.model_zoo.vision of the port: the ResNet v1 family."""
from .resnet import *
from .resnet import __all__ as _resnet_all

__all__ = list(_resnet_all) + ["get_model"]


def get_model(name, **kwargs):
    """A zoo model by name (the ported ones: ``resnet{18,34,50,101,152}_v1``)."""
    models = {"resnet18_v1": resnet18_v1, "resnet34_v1": resnet34_v1,
              "resnet50_v1": resnet50_v1, "resnet101_v1": resnet101_v1,
              "resnet152_v1": resnet152_v1}
    name = name.lower()
    if name not in models:
        raise ValueError(f"model '{name}' is not in the port's zoo "
                         f"({sorted(models)})")
    return models[name](**kwargs)
