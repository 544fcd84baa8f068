"""One iteration of MXNet 1.0's ``example/gan/dcgan.py`` in the port and
in the JAX package, on the host, from the same weights, noise and images.

The nets are dcgan.py's (Radford et al. 2016): a generator of five 4x4
``Deconvolution``s with train-mode ``BatchNorm`` (``fix_gamma``, eps 1e-5
+ 1e-12) and relu, tanh at the end; a discriminator of 4x4 stride-2
convolutions with ``LeakyReLU`` 0.2 and BatchNorm, a 4x4 convolution to
one logit, ``Flatten`` and ``LogisticRegressionOutput``.  The widths are
cut to ngf = ndf = 8, Z 16, batch 4 at dcgan.py's 64x64x3 images.  The
iteration is dcgan.py's: D on the fake batch (label 0), its gradients
copied aside; D on the real batch (label 1), the copies added in place
into ``modD._exec_group.grad_arrays``; ``modD.update()``; D on the fake
batch with label 1, ``get_input_grads()`` into ``modG.backward``;
``modG.update()``; Adam at lr 2e-4, beta1 0.5, wd 0.

Tolerances: D's and G's outputs atol=rtol=1e-5 (the same f32 math in
another order), D's input gradients, both nets' gradients and every updated
parameter and BatchNorm moving statistic atol=rtol=1e-4.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx

import mxnet_tpu_torch as mx

from dcgan_net import dcgan_iteration, dcgan_modules, dcgan_symbols, \
    dcgan_weights

CFG = dict(ngf=8, ndf=8, nc=3, z=16, batch=4, size=64)
OUT_TOL = dict(atol=1e-5, rtol=1e-5)
GRAD_TOL = dict(atol=1e-4, rtol=1e-4)
D_SHAPES = {"data": (CFG["batch"], CFG["nc"], CFG["size"], CFG["size"]),
            "label": (CFG["batch"],)}


@pytest.fixture(scope="module")
def both_iterations():
    """Both packages' iteration.  The port's runs on one host thread: with
    several, MKL's dynamic threading sums in an order that varies with
    the machine's load, and the BatchNorm nets carry a last-bit change
    into the 1e-4 digits of later tensors."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return _both_iterations()
    finally:
        torch.set_num_threads(threads)


def _both_iterations():
    rng = np.random.RandomState(0)
    noise = rng.randn(CFG["batch"], CFG["z"], 1, 1).astype(np.float32)
    real = rng.uniform(-1, 1, D_SHAPES["data"]).astype(np.float32)
    sym_g, sym_d = dcgan_symbols(mx.sym, CFG["ngf"], CFG["ndf"])
    weights_g = dcgan_weights(sym_g, {"rand": noise.shape}, 1)
    weights_d = dcgan_weights(sym_d, D_SHAPES, 2)
    out = {}
    for pkg in (jmx, mx):
        mods = dcgan_modules(pkg, pkg.cpu(), CFG, weights_g, weights_d)
        out[pkg] = dcgan_iteration(pkg, pkg.cpu(), *mods, noise, real)
    return out[jmx], out[mx], weights_g, weights_d


@pytest.mark.parametrize("key", ["G", "D fake", "D real", "D fake as real"])
def test_outputs(both_iterations, key):
    want, got = both_iterations[0][key], both_iterations[1][key]
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **OUT_TOL)


def test_discriminator_input_gradients(both_iterations):
    want, got = both_iterations[0], both_iterations[1]
    assert got["D input grads"].shape == D_SHAPES["data"]
    assert np.abs(got["D input grads"]).max() > 0
    np.testing.assert_allclose(got["D input grads"], want["D input grads"],
                               **GRAD_TOL)


@pytest.mark.parametrize("key", ["D grads", "G grads"])
def test_gradients(both_iterations, key):
    """D's: the fake batch's gradients added in place into the arrays
    ``update()`` reads; G's: from D's input gradients."""
    want, got = both_iterations[0][key], both_iterations[1][key]
    assert sorted(got) == sorted(want)
    for name in want:
        np.testing.assert_allclose(got[name], want[name], err_msg=name,
                                   **GRAD_TOL)


@pytest.mark.parametrize("net", ["G", "D"])
def test_updated_parameters(both_iterations, net):
    want, got, weights_g, weights_d = both_iterations
    start = (weights_g if net == "G" else weights_d)[0]
    moved = 0
    for key in (net + " params", net + " aux"):
        assert sorted(got[key]) == sorted(want[key])
        for name in want[key]:
            np.testing.assert_allclose(got[key][name], want[key][name],
                                       err_msg=name, **GRAD_TOL)
            if name in start:
                moved += not np.array_equal(got[key][name], start[name])
    assert moved > 0


def test_the_gradient_add_writes_into_the_bound_gradient():
    """``gradr += gradf`` on ``modD._exec_group.grad_arrays`` changes the
    very tensor the executor's ``grad_dict`` holds, which ``update()``
    reads."""
    _, sym_d = dcgan_symbols(mx.sym, CFG["ngf"], CFG["ndf"])
    args, _ = dcgan_weights(sym_d, D_SHAPES, 3)
    mod = mx.mod.Module(sym_d, data_names=("data",), label_names=("label",),
                        context=mx.cpu())
    mod.bind(data_shapes=[("data", D_SHAPES["data"])],
             label_shapes=[("label", D_SHAPES["label"])],
             inputs_need_grad=True)
    mod.init_params(arg_params={k: mx.nd.array(v, ctx=mx.cpu())
                                for k, v in args.items()})
    exe = mod._exec_group.execs[0]
    name = mod._param_names[0]
    grad = mod._exec_group.grad_arrays[0][0]
    assert grad is exe.grad_dict[name]
    before = grad.tensor
    grad += mx.nd.ones(grad.shape, ctx=mx.cpu())
    assert grad.tensor is before
    np.testing.assert_array_equal(exe.grad_dict[name].asnumpy(), 1.0)
