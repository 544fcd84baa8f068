"""The dense-op slice as a whole, and the ``BatchEndParam`` repair (C14).

MXNet 1.0's LeNet-STN (``example/image-classification/symbols/lenet.py``
with ``add_stn=True``): a localisation net feeding ``SpatialTransformer``,
then LeNet.  A small copy (batch 8, 2 steps of SGD with momentum) is
trained through ``Module.fit`` on the host in both packages from the JAX
package's initial weights (Xavier, then ``stn_loc``'s weight zeroed and its
bias the identity transform, as the initializers' legacy ``stn_loc`` rule
sets them), carried over as numpy arrays through
``convert.params_from_numpy``.  The JAX package's
``SpatialTransformer`` returns float64 for float32 data, which its next
``Convolution`` refuses (ROADMAP R15), so its copy of the graph casts the
sampler's output to float32; the port's graph is MXNet 1.0's.
Tolerance: every trained parameter within 1e-5 relative L2 of the JAX
package's.
"""
import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu.symbol.symbol import NameManager as JNameManager

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import convert

STN_BATCH = 8
STN_STEPS = 2
STN_REL = 1e-5


def stn_lenet(S, cast=False):
    """LeNet-STN from ``mx.sym`` ops; ``cast`` casts the transformer's
    output to float32 (for the JAX package, R15)."""
    data = S.var("data")
    loc = S.Convolution(data, num_filter=30, kernel=(5, 5), stride=(2, 2))
    loc = S.Activation(loc, act_type="relu")
    loc = S.Pooling(loc, kernel=(2, 2), stride=(2, 2), pool_type="max")
    loc = S.Convolution(loc, num_filter=60, kernel=(3, 3), pad=(1, 1))
    loc = S.Activation(loc, act_type="relu")
    loc = S.Pooling(loc, global_pool=True, kernel=(2, 2), pool_type="avg")
    loc = S.Flatten(loc)
    loc = S.FullyConnected(loc, num_hidden=6, name="stn_loc",
                           weight=S.var("stn_loc_weight", lr_mult=0.01),
                           bias=S.var("stn_loc_bias", lr_mult=0.01))
    x = S.SpatialTransformer(data=data, loc=loc, target_shape=(28, 28),
                             transform_type="affine", sampler_type="bilinear")
    if cast:
        x = S.Cast(x, dtype="float32")
    x = S.Convolution(x, kernel=(5, 5), num_filter=20)
    x = S.Activation(x, act_type="tanh")
    x = S.Pooling(x, pool_type="max", kernel=(2, 2), stride=(2, 2))
    x = S.Convolution(x, kernel=(5, 5), num_filter=50)
    x = S.Activation(x, act_type="tanh")
    x = S.Pooling(x, pool_type="max", kernel=(2, 2), stride=(2, 2))
    x = S.Flatten(x)
    x = S.FullyConnected(x, num_hidden=500)
    x = S.Activation(x, act_type="tanh")
    x = S.FullyConnected(x, num_hidden=10)
    return S.SoftmaxOutput(x, name="softmax")


def _digits(n, seed):
    """Images of a bright bar whose position codes the label, on noise."""
    rng = np.random.RandomState(seed)
    y = rng.randint(0, 10, n)
    x = rng.rand(n, 1, 28, 28).astype(np.float32) * 0.2
    for i, c in enumerate(y):
        x[i, 0, 4 + 2 * c:6 + 2 * c, 6:22] += 0.8
    return x, y.astype(np.float32)


def _jax_initial_weights():
    with JNameManager():
        sym = stn_lenet(jmx.sym, cast=True)
    mod = jmx.mod.Module(sym, context=jmx.cpu())
    mod.bind(data_shapes=[("data", (STN_BATCH, 1, 28, 28))],
             label_shapes=[("softmax_label", (STN_BATCH,))])
    jmx.random.seed(3)
    mod.init_params(initializer=jmx.initializer.Xavier(
        rnd_type="gaussian", factor_type="in", magnitude=2))
    args, _ = mod.get_params()
    weights = {k: v.asnumpy().copy() for k, v in args.items()}
    weights["stn_loc_weight"][:] = 0
    weights["stn_loc_bias"][:] = (1, 0, 0, 0, 1, 0)
    return weights


def _fit(pkg, sym, ctx, arg_params, x, y):
    it = pkg.io.NDArrayIter(x, y, batch_size=STN_BATCH, shuffle=False)
    mod = pkg.mod.Module(sym, context=ctx)
    mod.fit(it, num_epoch=1, arg_params=arg_params,
            optimizer_params={"learning_rate": 0.05, "momentum": 0.9,
                              "wd": 1e-4})
    args, _ = mod.get_params()
    return {k: v.asnumpy().astype(np.float64) for k, v in args.items()}


def test_lenet_stn_fit_matches_the_jax_package():
    weights = _jax_initial_weights()
    x, y = _digits(STN_BATCH * STN_STEPS, 7)
    with JNameManager():
        jsym = stn_lenet(jmx.sym, cast=True)
    want = _fit(jmx, jsym, jmx.cpu(),
                {k: jmx.nd.array(v) for k, v in weights.items()}, x, y)
    with mx.sym.NameManager():
        tsym = stn_lenet(mx.sym)
    arg_params, aux_params = convert.params_from_numpy(weights, mx.cpu())
    assert aux_params == {}
    got = _fit(mx, tsym, mx.cpu(), arg_params, x, y)
    assert sorted(got) == sorted(want) == sorted(weights)
    for k in want:
        assert np.linalg.norm(want[k] - weights[k]) > 0, k
        rel = np.linalg.norm(got[k] - want[k]) / np.linalg.norm(want[k])
        assert rel <= STN_REL, (k, rel)


@pytest.mark.parametrize("pkg", [jmx, mx], ids=["jax", "port"])
def test_batch_end_param_unpacks_and_indexes(pkg):
    """C14: ``mx.model.BatchEndParam`` is the namedtuple in both packages."""
    p = pkg.model.BatchEndParam(0, 1, None, None)
    epoch, nbatch, metric, loc = p
    assert (epoch, nbatch, metric, loc) == (0, 1, None, None)
    assert p[1] == 1 and p.nbatch == 1 and len(p) == 4
    assert p == pkg.model.BatchEndParam(epoch=0, nbatch=1, eval_metric=None,
                                        locals=None)


def test_fit_still_hands_callbacks_the_base_module_object():
    """``fit``'s batch-end callbacks get ``module/base_module.py``'s object
    (attributes, not a tuple), in the port as in the JAX package."""
    from mxnet_tpu_torch.module.base_module import BatchEndParam
    seen = []
    x, y = _digits(16, 1)
    sym = mx.sym.SoftmaxOutput(mx.sym.FullyConnected(
        mx.sym.Flatten(mx.sym.var("data")), num_hidden=10), name="softmax")
    mod = mx.mod.Module(sym, context=mx.cpu())
    mod.fit(mx.io.NDArrayIter(x, y, batch_size=8), num_epoch=1,
            batch_end_callback=seen.append)
    assert len(seen) == 2 and all(isinstance(p, BatchEndParam) for p in seen)
    assert [p.nbatch for p in seen] == [0, 1]
