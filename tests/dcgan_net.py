"""MXNet 1.0's ``example/gan/dcgan.py`` (Radford, Metz and Chintala 2016,
arXiv:1511.06434) over either package: its two symbols, Normal(0.02)
weights as numpy arrays, its two Modules and one training iteration.
Imports neither package itself, so the host parity tests and the card
tests share it.
"""
import numpy as np

EPS = 1e-5 + 1e-12
ADAM = {"learning_rate": 2e-4, "wd": 0.0, "beta1": 0.5}


def dcgan_symbols(sym, ngf, ndf, nc=3):
    """dcgan.py's ``make_dcgan_sym`` (no_bias, fix_gamma): the generator's
    output and the discriminator's ``LogisticRegressionOutput``."""
    def bn(x, name):
        return sym.BatchNorm(x, name=name, fix_gamma=True, eps=EPS)

    x = sym.Variable("rand")
    for i, width in enumerate([ngf * 8, ngf * 4, ngf * 2, ngf], 1):
        stride = dict(stride=(2, 2), pad=(1, 1)) if i > 1 else {}
        x = sym.Deconvolution(x, name="g%d" % i, kernel=(4, 4),
                              num_filter=width, no_bias=True, **stride)
        x = sym.Activation(bn(x, "gbn%d" % i), name="gact%d" % i,
                           act_type="relu")
    x = sym.Deconvolution(x, name="g5", kernel=(4, 4), stride=(2, 2),
                          pad=(1, 1), num_filter=nc, no_bias=True)
    gout = sym.Activation(x, name="gact5", act_type="tanh")

    d = sym.Variable("data")
    for i, width in enumerate([ndf, ndf * 2, ndf * 4, ndf * 8], 1):
        d = sym.Convolution(d, name="d%d" % i, kernel=(4, 4), stride=(2, 2),
                            pad=(1, 1), num_filter=width, no_bias=True)
        if i > 1:
            d = bn(d, "dbn%d" % i)
        d = sym.LeakyReLU(d, name="dact%d" % i, act_type="leaky", slope=0.2)
    d = sym.Convolution(d, name="d5", kernel=(4, 4), num_filter=1,
                        no_bias=True)
    d = sym.Flatten(d)
    dloss = sym.LogisticRegressionOutput(data=d, label=sym.Variable("label"),
                                         name="dloss")
    return gout, dloss


def dcgan_weights(symbol, shapes, seed):
    """Normal(0.02) weights, unit gammas, zero betas, moving statistics 0
    and 1 (dcgan.py's ``mx.init.Normal(0.02)`` by the initializer's name
    rules), as numpy arrays: (args, auxs)."""
    rng = np.random.RandomState(seed)
    arg_shapes, _, aux_shapes = symbol.infer_shape(**shapes)
    args = {}
    for name, shape in zip(symbol.list_arguments(), arg_shapes):
        if name in shapes:
            continue
        if name.endswith("gamma"):
            args[name] = np.ones(shape, np.float32)
        elif name.endswith("beta"):
            args[name] = np.zeros(shape, np.float32)
        else:
            args[name] = (rng.randn(*shape) * 0.02).astype(np.float32)
    auxs = {name: (np.zeros if name.endswith("mean") else np.ones)(
        shape, np.float32)
        for name, shape in zip(symbol.list_auxiliary_states(), aux_shapes)}
    return args, auxs


def dcgan_modules(pkg, ctx, cfg, weights_g, weights_d):
    """dcgan.py's ``modG`` and ``modD`` (``inputs_need_grad``) on ``ctx``,
    from numpy weights, with its Adam."""
    sym_g, sym_d = dcgan_symbols(pkg.sym, cfg["ngf"], cfg["ndf"], cfg["nc"])

    def nd(table):
        return {k: pkg.nd.array(v, ctx=pkg.cpu()) for k, v in table.items()}

    b = cfg["batch"]
    mod_g = pkg.mod.Module(sym_g, data_names=("rand",), label_names=None,
                           context=ctx)
    mod_g.bind(data_shapes=[("rand", (b, cfg["z"], 1, 1))])
    mod_g.init_params(arg_params=nd(weights_g[0]),
                      aux_params=nd(weights_g[1]))
    mod_g.init_optimizer(optimizer="adam", optimizer_params=dict(ADAM))
    mod_d = pkg.mod.Module(sym_d, data_names=("data",),
                           label_names=("label",), context=ctx)
    mod_d.bind(data_shapes=[("data", (b, cfg["nc"], cfg["size"],
                                      cfg["size"]))],
               label_shapes=[("label", (b,))], inputs_need_grad=True)
    mod_d.init_params(arg_params=nd(weights_d[0]),
                      aux_params=nd(weights_d[1]))
    mod_d.init_optimizer(optimizer="adam", optimizer_params=dict(ADAM))
    return mod_g, mod_d


def dcgan_iteration(pkg, ctx, mod_g, mod_d, noise, real):
    """dcgan.py's training iteration on numpy ``noise`` and ``real``
    images; returns what it computed, as numpy: G's output, D's three
    outputs, D's summed gradients, D's input gradients, G's gradients,
    and both nets' parameters and moving statistics after the updates."""
    seen = {}
    label = pkg.nd.zeros((noise.shape[0],), ctx=ctx)
    mod_g.forward(pkg.io.DataBatch([pkg.nd.array(noise, ctx=ctx)], []),
                  is_train=True)
    out_g = mod_g.get_outputs()
    seen["G"] = out_g[0].asnumpy()
    label[:] = 0
    mod_d.forward(pkg.io.DataBatch(out_g, [label]), is_train=True)
    mod_d.backward()
    grad_d = [[g.copyto(g.context) for g in grads]
              for grads in mod_d._exec_group.grad_arrays]
    seen["D fake"] = mod_d.get_outputs()[0].asnumpy()
    label[:] = 1
    mod_d.forward(pkg.io.DataBatch([pkg.nd.array(real, ctx=ctx)], [label]),
                  is_train=True)
    mod_d.backward()
    for grads_r, grads_f in zip(mod_d._exec_group.grad_arrays, grad_d):
        for grad_r, grad_f in zip(grads_r, grads_f):
            grad_r += grad_f
    seen["D grads"] = {n: g[0].asnumpy() for n, g in zip(
        mod_d._param_names, mod_d._exec_group.grad_arrays)}
    mod_d.update()
    seen["D real"] = mod_d.get_outputs()[0].asnumpy()
    label[:] = 1
    mod_d.forward(pkg.io.DataBatch(out_g, [label]), is_train=True)
    mod_d.backward()
    diff_d = mod_d.get_input_grads()
    seen["D fake as real"] = mod_d.get_outputs()[0].asnumpy()
    seen["D input grads"] = diff_d[0].asnumpy()
    mod_g.backward(diff_d)
    seen["G grads"] = {n: g[0].asnumpy() for n, g in zip(
        mod_g._param_names, mod_g._exec_group.grad_arrays)}
    mod_g.update()
    for tag, mod in (("G", mod_g), ("D", mod_d)):
        args, auxs = mod.get_params()
        seen[tag + " params"] = {k: v.asnumpy() for k, v in args.items()}
        seen[tag + " aux"] = {k: v.asnumpy() for k, v in auxs.items()}
    return seen


OUTPUTS = ("G", "D fake", "D real", "D fake as real")
TENSORS = ("D input grads", "D grads", "G grads", "G params", "D params",
           "G aux", "D aux")


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def gaps_within_floor(got, want, floors, out_tol=1e-4, rel=1e-3):
    """The comparison of ``got`` (one iteration's ``dcgan_iteration``
    record) with ``want`` by chip_smoke.py phase 12b's rule: each output
    within atol=rtol=``out_tol`` or within 4 times its floor's largest
    error; each gradient, parameter and moving statistic within ``rel``
    relative L2 or within 4 times the largest floor of its kind (record
    and name suffix); a tensor's floor is the largest distance from
    ``want`` of ``floors`` (the same run with its inputs moved by one
    ulp).  Returns [(tag, error, floor)] of what fails."""
    bad = []
    for key in OUTPUTS:
        err = np.abs(got[key] - want[key])
        fl = max(float(np.abs(f[key] - want[key]).max()) for f in floors)
        if not ((err <= out_tol + out_tol * np.abs(want[key])).all()
                or err.max() <= 4.0 * fl):
            bad.append((key, float(err.max()), fl))
    rows, kind_floor = [], {}
    for key in TENSORS:
        names = [None] if not isinstance(want[key], dict) else [
            n for n in want[key] if np.linalg.norm(want[key][n]) > 0]
        for n in names:
            def pick(record):
                return record[key] if n is None else record[key][n]
            kind = key if n is None else "%s %s" % (key, n.rsplit("_", 1)[-1])
            fl = max(_rel_l2(pick(f), pick(want)) for f in floors)
            kind_floor[kind] = max(kind_floor.get(kind, 0.0), fl)
            rows.append((key if n is None else "%s %s" % (key, n), kind,
                         _rel_l2(pick(got), pick(want))))
    for tag, kind, err in rows:
        if err > max(rel, 4.0 * kind_floor[kind]):
            bad.append((tag, err, kind_floor[kind]))
    return bad
