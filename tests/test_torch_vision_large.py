"""The Inception v3 builder of the Gluon vision zoo in the port against
the JAX package's at its smallest input (299x299): equal parameter names
and shapes, and an equal hybridized predict-mode forward after
``convert.set_gluon_params`` (relative L2 1e-5; see
``tests/test_torch_vision_zoo.py``); and one SGD-momentum Trainer step of
the zoo's ``DenseNet`` class at its smallest depth (one layer a dense
block, 16 initial features, growth 8) at 221x221, batch 1 (the rule of
``tests/test_torch_vision_train.py``): the DenseNet layers, transitions
and concatenations of every depth, at a fraction of DenseNet-121's
cost.  The DenseNet builders are in
``tests/test_torch_vision_densenet.py``."""
import pytest

from mxnet_tpu.symbol.symbol import NameManager as JNameManager

import mxnet_tpu_torch as mx
from mxnet_tpu_torch.gluon.model_zoo import vision
from mxnet_tpu_torch.symbol import NameManager

from test_torch_vision_train import check_one_step
from test_torch_vision_zoo import CLASSES, check_builder


@pytest.mark.parametrize("name", sorted(
    n for n in vision._MODELS if n.startswith("inception")))
def test_large_builder_matches_the_jax_package(name):
    check_builder(name)


def shallow_densenet(pkg):
    with (NameManager if pkg is mx else JNameManager)():
        return pkg.gluon.model_zoo.vision.DenseNet(16, 8, [1, 1, 1, 1],
                                                   classes=CLASSES)


def test_one_sgd_momentum_step_matches_the_jax_package():
    check_one_step("densenet", 1, 221, make=shallow_densenet)
