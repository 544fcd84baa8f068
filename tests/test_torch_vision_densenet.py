"""Every DenseNet builder of the Gluon vision zoo (121, 161, 169, 201) in
the port against the JAX package's at its smallest input (221x221: its
last pool is 7x7 at a 32nd of the input): equal parameter names and
shapes, and an equal hybridized predict-mode forward after
``convert.set_gluon_params`` (relative L2 1e-5; see
``tests/test_torch_vision_zoo.py``)."""
import pytest

from mxnet_tpu_torch.gluon.model_zoo import vision

from test_torch_vision_zoo import check_builder


@pytest.mark.parametrize("name", sorted(
    n for n in vision._MODELS if n.startswith("densenet")))
def test_densenet_builder_matches_the_jax_package(name):
    check_builder(name)
