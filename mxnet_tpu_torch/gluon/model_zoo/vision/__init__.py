"""Vision model zoo (ref: python/mxnet/gluon/model_zoo/vision/).

Counterpart of ``mxnet_tpu/gluon/model_zoo/vision/__init__.py``: every
builder importable by name, and ``get_model`` over a registry assembled
from the submodules' exported builders, with the reference's dotted
spellings (``squeezenet1.0``, ``mobilenet0.25``, ``inceptionv3``).
"""
from . import (alexnet as _m_alexnet, densenet as _m_densenet,
               inception as _m_inception, mobilenet as _m_mobilenet,
               resnet as _m_resnet, squeezenet as _m_squeezenet,
               vgg as _m_vgg)
from .alexnet import *  # noqa: F401,F403
from .densenet import *  # noqa: F401,F403
from .inception import *  # noqa: F401,F403
from .mobilenet import *  # noqa: F401,F403
from .resnet import *  # noqa: F401,F403
from .squeezenet import *  # noqa: F401,F403
from .vgg import *  # noqa: F401,F403

# registry names follow the reference spelling: squeezenet/mobilenet
# versions are dotted ("squeezenet1.0"), everything else underscored
_ALIAS = {"squeezenet1_0": "squeezenet1.0", "squeezenet1_1": "squeezenet1.1",
          "mobilenet1_0": "mobilenet1.0", "mobilenet0_75": "mobilenet0.75",
          "mobilenet0_5": "mobilenet0.5", "mobilenet0_25": "mobilenet0.25",
          "inception_v3": "inceptionv3"}


def _collect():
    registry = {}
    for mod in (_m_alexnet, _m_densenet, _m_inception, _m_mobilenet,
                _m_resnet, _m_squeezenet, _m_vgg):
        for name in getattr(mod, "__all__", ()):
            entry = getattr(mod, name)
            if callable(entry) and not isinstance(entry, type) \
                    and not name.startswith(("get_",)):
                registry[_ALIAS.get(name, name)] = entry
    return registry


_MODELS = _collect()


def get_model(name, **kwargs):
    """Return a model by name, e.g. get_model('resnet50_v1', classes=10)."""
    key = name.lower()
    if key not in _MODELS:
        raise ValueError("Model %r not found; available: %s"
                         % (name, sorted(_MODELS)))
    return _MODELS[key](**kwargs)
