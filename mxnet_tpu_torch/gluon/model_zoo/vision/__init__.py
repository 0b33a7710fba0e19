"""gluon.model_zoo.vision of the port: ResNet V1 and V2, VGG, AlexNet,
DenseNet, SqueezeNet, MobileNet V1 and V2 and Inception V3, and
``get_model`` over them."""
from .alexnet import *
from .alexnet import __all__ as _alexnet_all
from .densenet import *
from .densenet import __all__ as _densenet_all
from .inception import *
from .inception import __all__ as _inception_all
from .mobilenet import *
from .mobilenet import __all__ as _mobilenet_all
from .resnet import *
from .resnet import __all__ as _resnet_all
from .squeezenet import *
from .squeezenet import __all__ as _squeezenet_all
from .vgg import *
from .vgg import __all__ as _vgg_all

__all__ = (list(_resnet_all) + list(_vgg_all) + list(_alexnet_all)
           + list(_densenet_all) + list(_squeezenet_all)
           + list(_mobilenet_all) + list(_inception_all) + ["get_model"])

_MODELS = {
    "resnet18_v1": resnet18_v1, "resnet34_v1": resnet34_v1,
    "resnet50_v1": resnet50_v1, "resnet101_v1": resnet101_v1,
    "resnet152_v1": resnet152_v1,
    "resnet18_v2": resnet18_v2, "resnet34_v2": resnet34_v2,
    "resnet50_v2": resnet50_v2, "resnet101_v2": resnet101_v2,
    "resnet152_v2": resnet152_v2,
    "vgg11": vgg11, "vgg13": vgg13, "vgg16": vgg16, "vgg19": vgg19,
    "vgg11_bn": vgg11_bn, "vgg13_bn": vgg13_bn, "vgg16_bn": vgg16_bn,
    "vgg19_bn": vgg19_bn,
    "alexnet": alexnet,
    "densenet121": densenet121, "densenet161": densenet161,
    "densenet169": densenet169, "densenet201": densenet201,
    "squeezenet1.0": squeezenet1_0, "squeezenet1.1": squeezenet1_1,
    "mobilenet1.0": mobilenet1_0, "mobilenet0.75": mobilenet0_75,
    "mobilenet0.5": mobilenet0_5, "mobilenet0.25": mobilenet0_25,
    "mobilenetv2_1.0": mobilenet_v2_1_0,
    "mobilenetv2_0.75": mobilenet_v2_0_75,
    "mobilenetv2_0.5": mobilenet_v2_0_5,
    "mobilenetv2_0.25": mobilenet_v2_0_25,
    "inceptionv3": inception_v3,
}


def get_model(name, **kwargs):
    """A zoo model by name, as the JAX package's ``get_model`` names
    them."""
    name = name.lower()
    if name not in _MODELS:
        raise ValueError(f"model '{name}' is not in the zoo "
                         f"({sorted(_MODELS)})")
    return _MODELS[name](**kwargs)
