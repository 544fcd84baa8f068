"""Symbol-API model builders (parity: example/image-classification/
symbols/), as the JAX package's ``models/`` exports them, and the
TransformerLM graph the port serves."""
from . import resnet  # noqa: F401
from . import resnet_v1  # noqa: F401
from . import resnext  # noqa: F401
from . import lenet  # noqa: F401
from . import mlp  # noqa: F401
from . import alexnet  # noqa: F401
from . import vgg  # noqa: F401
from . import googlenet  # noqa: F401
from . import mobilenet  # noqa: F401
from . import inception_bn  # noqa: F401
from . import inception_v3  # noqa: F401
from . import inception_v4  # noqa: F401
from . import inception_resnet_v2  # noqa: F401
from . import rcnn_vgg  # noqa: F401
from .transformer_lm import transformer_lm_symbol  # noqa: F401

get_symbol = resnet.get_symbol
