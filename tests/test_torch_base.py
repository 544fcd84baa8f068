"""The port's attr-string reflection and dtype names against the JAX
package's ``base.py``: a graph's attrs are strings in the JSON both
packages read, so both must print and parse them alike.  Exact equality
(no arithmetic involved)."""
import numpy as np
import pytest
import torch

from mxnet_tpu import base as jbase
from mxnet_tpu.ops import registry as jreg

from mxnet_tpu_torch import base as tbase
from mxnet_tpu_torch.ops import registry as treg

VALUES = [3, -1, 0.5, 1e-5, True, False, None, "gelu", (1, 2), [3, 4, 5],
          (), (7,)]
STRINGS = ["3", "-1", "0.5", "1e-05", "True", "false", "None", "", "gelu",
           "(1, 2)", "[3, 4, 5]", "()", "(7,)", " ( 2 , 3 ) ", "(None, 2)"]
SHAPES = [None, 4, "4", "(2, 3)", "[1, 1]", (5, 6), [7], "()", (np.int64(3),)]
DTYPES = ["float32", "float16", "int32", "int64", "uint8", "int8", "bool",
          np.float32, np.dtype("int32"), None]


@pytest.mark.parametrize("value", VALUES, ids=repr)
def test_attr_to_str_matches_jax(value):
    assert tbase.attr_to_str(value) == jbase.attr_to_str(value)


@pytest.mark.parametrize("text", STRINGS, ids=repr)
def test_str_to_attr_matches_jax(text):
    assert tbase.str_to_attr(text) == jbase.str_to_attr(text)


@pytest.mark.parametrize("value", SHAPES, ids=repr)
def test_shape_attr_matches_jax(value):
    assert tbase.shape_attr(value) == jbase.shape_attr(value)
    assert treg.pShape(value) == jreg.pShape(value)


@pytest.mark.parametrize("dtype", DTYPES, ids=repr)
def test_dtype_name_matches_jax(dtype):
    name = tbase.dtype_name(dtype)
    if dtype is not None:  # the JAX helper has no None spelling
        assert name == jbase.dtype_name(dtype)
    assert tbase.np_dtype(name) == jbase.np_dtype(name)
    assert tbase.dtype_name(tbase.torch_dtype(name)) == name


def test_bfloat16_is_named_and_kept():
    assert tbase.dtype_name("bfloat16") == "bfloat16"
    assert tbase.dtype_name(torch.bfloat16) == "bfloat16"
    assert tbase.np_dtype("bfloat16") is torch.bfloat16
    assert tbase.torch_dtype("bfloat16") is torch.bfloat16
