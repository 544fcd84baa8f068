"""Every ResNet v2 builder of the Gluon vision zoo (depths 18 to 152,
thumbnail form at 32x32) in the port against the JAX package's: equal
parameter names and shapes, and an equal hybridized predict-mode
forward after ``convert.set_gluon_params`` (relative L2 1e-5; see
``tests/test_torch_vision_zoo.py``)."""
import pytest

from mxnet_tpu_torch.gluon.model_zoo import vision

from test_torch_vision_zoo import check_builder


@pytest.mark.parametrize("name", sorted(
    n for n in vision._MODELS if n.startswith("resnet") and
    n.endswith("_v2")))
def test_resnet_v2_builder_matches_the_jax_package(name):
    check_builder(name)
