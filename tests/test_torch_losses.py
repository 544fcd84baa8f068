"""The port's Gluon losses and the CTC op (``mxnet_tpu_torch``) against
the JAX package, on the CPU, from seeded numpy inputs.

Each loss runs plain, with a constant ``weight``, with a positional
``sample_weight`` and hybridized; values atol=rtol=1e-5, the gradient of
the prediction atol=rtol=1e-4.  The CTC op runs with blank ``first`` and
``last``, ragged padding, the op's own length inputs and an impossible
alignment (about 1e30 in both packages, not inf); the JAX side of each
op case is one jitted program of ``_ctc_loss`` and its gradient.
"""
import functools

import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu.symbol.symbol import NameManager as JNameManager

import mxnet_tpu_torch as mx
from mxnet_tpu_torch.symbol import NameManager

FWD = dict(atol=1e-5, rtol=1e-5)
GRAD = dict(atol=1e-4, rtol=1e-4)
PKGS = (mx, jmx)
B = 4


def names(pkg):
    return NameManager() if pkg is mx else JNameManager()


def arr(pkg, a):
    return pkg.nd.array(np.asarray(a, np.float32), ctx=pkg.cpu())


def sigmoid(x):
    return 1 / (1 + np.exp(-x))


def log_softmax(x):
    x = x - x.max(-1, keepdims=True)
    return x - np.log(np.exp(x).sum(-1, keepdims=True))


# name: (class, kwargs, fn(RandomState) -> [pred, targets...])
LOSSES = {
    "l2": ("L2Loss", {}, lambda r: [r.normal(size=(B, 3, 2)),
                                    r.normal(size=(B, 6))]),
    "l1": ("L1Loss", {}, lambda r: [r.normal(size=(B, 5)),
                                    r.normal(size=(B, 5))]),
    "huber": ("HuberLoss", {"rho": 0.7},
              lambda r: [r.normal(size=(B, 6)), r.normal(size=(B, 6))]),
    "sigmoid_bce": ("SigmoidBinaryCrossEntropyLoss", {},
                    lambda r: [r.normal(size=(B, 5)) * 3,
                               r.randint(0, 2, (B, 5))]),
    "sigmoid_bce_from_sigmoid": (
        "SigmoidBCELoss", {"from_sigmoid": True},
        lambda r: [sigmoid(r.normal(size=(B, 5))), r.randint(0, 2, (B, 5))]),
    "softmax_ce": ("SoftmaxCrossEntropyLoss", {},
                   lambda r: [r.normal(size=(B, 7)), r.randint(0, 7, (B,))]),
    "softmax_ce_dense": (
        "SoftmaxCELoss", {"sparse_label": False},
        lambda r: [r.normal(size=(B, 7)),
                   np.exp(log_softmax(r.normal(size=(B, 7))))]),
    "kldiv": ("KLDivLoss", {"from_logits": False},
              lambda r: [r.normal(size=(B, 6)),
                         np.exp(log_softmax(r.normal(size=(B, 6))))]),
    "kldiv_from_logits": (
        "KLDivLoss", {},
        lambda r: [log_softmax(r.normal(size=(B, 6))),
                   np.exp(log_softmax(r.normal(size=(B, 6))))]),
    "hinge": ("HingeLoss", {"margin": 1.5},
              lambda r: [r.normal(size=(B, 5)),
                         r.choice([-1.0, 1.0], (B, 5))]),
    "squared_hinge": ("SquaredHingeLoss", {},
                      lambda r: [r.normal(size=(B, 5)),
                                 r.choice([-1.0, 1.0], (B, 5))]),
    "logistic_signed": ("LogisticLoss", {},
                        lambda r: [r.normal(size=(B, 5)) * 2,
                                   r.choice([-1.0, 1.0], (B, 5))]),
    "logistic_binary": ("LogisticLoss", {"label_format": "binary"},
                        lambda r: [r.normal(size=(B, 5)) * 2,
                                   r.randint(0, 2, (B, 5))]),
    "triplet": ("TripletLoss", {"margin": 2.0},
                lambda r: [r.normal(size=(B, 4)), r.normal(size=(B, 4)),
                           r.normal(size=(B, 4))]),
}
VARIANTS = ("plain", "weight", "sample_weight", "hybridized")


def run_loss(pkg, name, variant, seed=0):
    cls, kwargs, make = LOSSES[name]
    r = np.random.RandomState(seed)
    pred, *targets = make(r)
    kwargs = dict(kwargs)
    if variant == "weight":
        kwargs["weight"] = 0.7
    with names(pkg):
        loss_fn = getattr(pkg.gluon.loss, cls)(**kwargs)
    if variant == "hybridized":
        loss_fn.hybridize()
    args = [arr(pkg, t) for t in targets]
    if variant == "sample_weight":  # one weight per sample, broadcastable
        per_sample = name == "triplet" or len(np.shape(pred)) == 1
        shape = (B,) + (1,) * (0 if per_sample else len(np.shape(pred)) - 1)
        args.append(arr(pkg, r.uniform(0, 2, shape)))
    p = arr(pkg, pred)
    p.attach_grad()
    with pkg.autograd.record():
        out = loss_fn(p, *args)
    out.backward(arr(pkg, np.linspace(0.5, 1.5, B)))
    return out.asnumpy(), p.grad.asnumpy()


_JAX_LOSS = {}


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("name", sorted(LOSSES))
def test_loss_matches_the_jax_package(name, variant):
    """The port's loss in each variant against the JAX package's; its
    hybridized form against the JAX package's plain run (a hybridized
    block computes the same function)."""
    jvariant = "plain" if variant == "hybridized" else variant
    if (name, jvariant) not in _JAX_LOSS:
        _JAX_LOSS[name, jvariant] = run_loss(jmx, name, jvariant)
    val, grad = run_loss(mx, name, variant)
    jval, jgrad = _JAX_LOSS[name, jvariant]
    assert val.shape == jval.shape == (B,)
    np.testing.assert_allclose(val, jval, **FWD)
    assert grad.shape == jgrad.shape
    np.testing.assert_allclose(grad, jgrad, **GRAD)


def test_loss_keyword_sample_weight_equals_the_positional_one():
    r = np.random.RandomState(2)
    pred, label, w = (arr(mx, r.normal(size=(B, 5))),
                      arr(mx, r.normal(size=(B, 5))),
                      arr(mx, r.uniform(size=(B, 1))))
    with names(mx):
        loss_fn = mx.gluon.loss.HuberLoss()
    np.testing.assert_array_equal(
        loss_fn.hybrid_forward(mx.nd, pred, label, sample_weight=w)
        .asnumpy(), loss_fn(pred, label, w).asnumpy())
    with names(mx):
        bad = mx.gluon.loss.L1Loss(weight="2")
    with pytest.raises(TypeError):
        bad(pred, label)
    with pytest.raises(ValueError):
        mx.gluon.loss.LogisticLoss(label_format="zero-one")


# ---------------------------------------------------------------------------
# CTC
# ---------------------------------------------------------------------------

T, A, L = 12, 6, 4


def ctc_case(case, seed=0):
    """(data [T, N, A], labels [N, L], data_lengths, label_lengths, attrs)
    for one op case."""
    r = np.random.RandomState(seed)
    blank_last = case.endswith("last")
    lo, hi = (0, A - 1) if blank_last else (1, A)
    pad = -1 if blank_last else 0
    labels = r.randint(lo, hi, (5, L)).astype(np.float32)
    labels[1, 2:] = pad  # ragged: two labels
    labels[2, 1:] = pad  # one label
    labels[3, 0] = labels[3, 1]  # a repeat needs a blank between
    data = r.normal(size=(T, 5, A)) * 2
    data_len = np.array([T, T - 3, 5, T, 7], np.float32)
    label_len = np.array([L, 2, 1, 3, L], np.float32)
    attrs = {"blank_label": "last" if blank_last else "first"}
    if case.startswith("impossible"):
        labels[0] = [1, 1, 1, 1]  # 4 repeats need 7 steps
        labels[4] = [1, 2, 2, 1]  # needs 5 steps
        data = data[:4]
        data_len = np.minimum(data_len, 4)
    if "lengths" in case:
        attrs.update(use_data_lengths=True, use_label_lengths=True)
    return data.astype(np.float32), labels, data_len, label_len, attrs


CTC_CASES = ["blank_first", "blank_last", "lengths_blank_first",
             "lengths_blank_last", "impossible_blank_first"]


def jax_ctc(case):
    import jax
    from mxnet_tpu.ops.contrib_ops import _ctc_loss
    data, labels, dlen, llen, attrs = ctc_case(case)
    extra = (dlen, llen) if attrs.get("use_data_lengths") else ()
    fn = functools.partial(_ctc_loss, **attrs)

    def run(data, head):
        loss, vjp = jax.vjp(lambda d: fn(d, labels, *extra), data)
        return loss, vjp(head)[0]

    head = np.linspace(0.5, 1.5, data.shape[1]).astype(np.float32)
    loss, grad = jax.jit(run)(data, head)
    return np.asarray(loss), np.asarray(grad)


def port_ctc(case, ctx=None):
    data, labels, dlen, llen, attrs = ctc_case(case)
    ctx = ctx or mx.cpu()
    d = mx.nd.array(data, ctx=ctx)
    d.attach_grad()
    args = [mx.nd.array(labels, ctx=ctx)]
    if attrs.get("use_data_lengths"):
        args += [mx.nd.array(dlen, ctx=ctx), mx.nd.array(llen, ctx=ctx)]
    with mx.autograd.record():
        loss = mx.nd.CTCLoss(d, *args, **attrs)
    loss.backward(mx.nd.array(np.linspace(0.5, 1.5, data.shape[1]),
                              ctx=ctx))
    return loss.asnumpy(), d.grad.asnumpy()


@pytest.mark.parametrize("case", CTC_CASES)
def test_ctc_op_and_its_gradient_match_the_jax_package(case):
    (loss, grad), (jloss, jgrad) = port_ctc(case), jax_ctc(case)
    assert loss.shape == (5,)
    np.testing.assert_allclose(loss, jloss, **FWD)
    np.testing.assert_allclose(grad, jgrad, **GRAD)
    assert np.isfinite(grad).all()
    if case.startswith("impossible"):
        assert 1e29 < loss[0] < 1e31 and 1e29 < loss[4] < 1e31
        assert loss[1] < 1e3


def test_ctc_op_names_and_lengths_against_torch():
    """The aliases reach the same op; on possible alignments the loss is
    torch's ``ctc_loss`` (sum reduction off), which gives inf where the
    port gives about 1e30."""
    import torch
    data, labels, dlen, llen, attrs = ctc_case("lengths_blank_first")
    d, y = mx.nd.array(data, ctx=mx.cpu()), mx.nd.array(labels, ctx=mx.cpu())
    lens = [mx.nd.array(dlen, ctx=mx.cpu()), mx.nd.array(llen, ctx=mx.cpu())]
    want = mx.nd.CTCLoss(d, y, *lens, **attrs).asnumpy()
    for alias in ("ctc_loss", "_contrib_CTCLoss", "_contrib_ctc_loss"):
        np.testing.assert_array_equal(
            getattr(mx.nd, alias)(d, y, *lens, **attrs).asnumpy(), want)
    ref = torch.nn.functional.ctc_loss(
        torch.log_softmax(torch.from_numpy(data), -1),
        torch.from_numpy(labels).long(), torch.from_numpy(dlen).long(),
        torch.from_numpy(llen).long(), blank=0, reduction="none")
    np.testing.assert_allclose(want, ref.numpy(), rtol=1e-5)


def gluon_ctc(pkg, layout, hybrid, lengths, seed=0):
    r = np.random.RandomState(seed)
    pred = r.normal(size=(3, 8, 5)).astype(np.float32)  # N, T, C
    labels = np.array([[1, 2, 3], [2, 2, 0], [4, 0, 0]], np.float32)
    if layout == "TNC":
        pred = pred.transpose(1, 0, 2)
    with names(pkg):
        loss_fn = pkg.gluon.loss.CTCLoss(layout=layout, weight=0.5)
    if hybrid:
        loss_fn.hybridize()
    p = arr(pkg, pred)
    p.attach_grad()
    args = [arr(pkg, labels)]
    if lengths:
        args += [arr(pkg, [5, 8, 2]), arr(pkg, [1, 1, 1])]
    with pkg.autograd.record():
        out = loss_fn(p, *args)
    out.backward()
    grad = p.grad.asnumpy()
    return out.asnumpy(), grad if layout == "TNC" else grad.transpose(1, 0, 2)


_JAX_GLUON_CTC = []


@pytest.mark.parametrize("layout,hybrid,lengths",
                         [("NTC", False, False), ("TNC", True, False),
                          ("NTC", False, True)],
                         ids=["ntc", "tnc-hybridized", "ntc-lengths"])
def test_gluon_ctc_loss_matches_the_jax_package(layout, hybrid, lengths):
    """Every form against one JAX run, hybridized in TNC and given the
    lengths, which it ignores (gradients compared in TNC): one program
    instead of the scan's many eager steps, and the JAX package's
    hybridized NTC form fails to build its graph."""
    if not _JAX_GLUON_CTC:
        _JAX_GLUON_CTC.append(gluon_ctc(jmx, "TNC", True, True))
    val, grad = gluon_ctc(mx, layout, hybrid, lengths)
    jval, jgrad = _JAX_GLUON_CTC[0]
    assert val.shape == (3,)
    np.testing.assert_allclose(val, jval, **FWD)
    np.testing.assert_allclose(grad, jgrad, **GRAD)


def test_gluon_ctc_loss_ignores_the_lengths_as_the_jax_package_does():
    """``gluon.loss.CTCLoss`` hands the lengths to the op without
    ``use_data_lengths``/``use_label_lengths``: the same loss as without
    them (ROADMAP R3)."""
    with_lengths, _ = gluon_ctc(mx, "NTC", False, True)
    without, _ = gluon_ctc(mx, "NTC", False, False)
    np.testing.assert_array_equal(with_lengths, without)
