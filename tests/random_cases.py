"""The random ops' test cases over either package: two parameter settings
per canonical op with the analytic mean and variance of each, the
support to check, and the checks.  Imports neither package itself, so
the host parity tests and the card tests share it.

The moment gate: the sample mean within ``SIGMAS`` standard errors of the
analytic mean, and the sample variance within ``SIGMAS`` standard errors
of the analytic variance, the variance's standard error estimated from
the sample's fourth central moment.
"""
import numpy as np

SIGMAS = 6.0
P_MIN = 1e-4

# canonical op -> its cases: scalar ``attrs`` or tensor ``params`` (one
# row per parameter), the analytic mean and variance (per row), the
# support, and whether the distribution is continuous
SPECS = {
    "_random_uniform": [
        dict(attrs={"low": -1.0, "high": 3.0}, mean=1.0, var=16 / 12,
             support=("range", -1.0, 3.0), continuous=True),
        dict(attrs={"low": 0.0, "high": 1.0}, mean=0.5, var=1 / 12,
             support=("range", 0.0, 1.0), continuous=True)],
    "_random_normal": [
        dict(attrs={"loc": 2.0, "scale": 0.5}, mean=2.0, var=0.25,
             support=("real",), continuous=True),
        dict(attrs={"loc": -10.0, "scale": 3.0}, mean=-10.0, var=9.0,
             support=("real",), continuous=True)],
    "_random_gamma": [
        dict(attrs={"alpha": 2.5, "beta": 1.5}, mean=3.75, var=5.625,
             support=("positive",), continuous=True),
        dict(attrs={"alpha": 0.5, "beta": 2.0}, mean=1.0, var=2.0,
             support=("positive",), continuous=True)],
    "_random_exponential": [
        dict(attrs={"lam": 2.0}, mean=0.5, var=0.25,
             support=("nonnegative",), continuous=True),
        dict(attrs={"lam": 0.1}, mean=10.0, var=100.0,
             support=("nonnegative",), continuous=True)],
    "_random_poisson": [
        dict(attrs={"lam": 4.0}, mean=4.0, var=4.0, support=("count",)),
        dict(attrs={"lam": 0.3}, mean=0.3, var=0.3, support=("count",))],
    "_random_negative_binomial": [
        dict(attrs={"k": 3, "p": 0.4}, mean=4.5, var=11.25,
             support=("count",)),
        dict(attrs={"k": 10, "p": 0.8}, mean=2.5, var=3.125,
             support=("count",))],
    "_random_generalized_negative_binomial": [
        dict(attrs={"mu": 5.0, "alpha": 0.3}, mean=5.0, var=12.5,
             support=("count",)),
        dict(attrs={"mu": 1.5, "alpha": 2.0}, mean=1.5, var=6.0,
             support=("count",))],
    "_random_randint": [
        dict(attrs={"low": -3, "high": 7}, mean=1.5, var=8.25,
             support=("integer", -3, 7)),
        dict(attrs={"low": 0, "high": 2}, mean=0.5, var=0.25,
             support=("integer", 0, 2))],
    "_sample_uniform": [
        dict(params=[[0.0, -2.0], [1.0, 2.0]], mean=[0.5, 0.0],
             var=[1 / 12, 16 / 12], support=("rows",), continuous=True),
        dict(params=[[5.0], [5.5]], mean=[5.25], var=[0.25 / 12],
             support=("rows",), continuous=True)],
    "_sample_normal": [
        dict(params=[[0.0, 3.0], [1.0, 0.5]], mean=[0.0, 3.0],
             var=[1.0, 0.25], support=("real",), continuous=True),
        dict(params=[[-1.0], [4.0]], mean=[-1.0], var=[16.0],
             support=("real",), continuous=True)],
    "_sample_gamma": [
        dict(params=[[1.0, 8.0], [1.0, 2.0]], mean=[1.0, 16.0],
             var=[1.0, 32.0], support=("positive",), continuous=True),
        dict(params=[[0.7], [0.5]], mean=[0.35], var=[0.175],
             support=("positive",), continuous=True)],
    "_sample_exponential": [
        dict(params=[[1.0, 4.0]], mean=[1.0, 0.25], var=[1.0, 1 / 16],
             support=("nonnegative",), continuous=True),
        dict(params=[[0.5]], mean=[2.0], var=[4.0],
             support=("nonnegative",), continuous=True)],
    "_sample_poisson": [
        dict(params=[[2.0, 10.0]], mean=[2.0, 10.0], var=[2.0, 10.0],
             support=("count",)),
        dict(params=[[30.0]], mean=[30.0], var=[30.0], support=("count",))],
    "_sample_negative_binomial": [
        dict(params=[[3.0, 5.0], [0.4, 0.7]], mean=[4.5, 5 * 0.3 / 0.7],
             var=[11.25, 5 * 0.3 / 0.49], support=("count",)),
        dict(params=[[1.0], [0.5]], mean=[1.0], var=[2.0],
             support=("count",))],
    "_sample_generalized_negative_binomial": [
        dict(params=[[5.0, 2.0], [0.3, 1.0]], mean=[5.0, 2.0],
             var=[12.5, 6.0], support=("count",)),
        dict(params=[[8.0], [0.1]], mean=[8.0], var=[14.4],
             support=("count",))],
}
PROBS = np.array([[0.1, 0.2, 0.3, 0.4], [0.5, 0.25, 0.125, 0.125]],
                 np.float32)
SHUFFLED = np.arange(40, dtype=np.float32).reshape(20, 2)


def call(pkg, name, shape, ctx, dtype=None, case=0):
    """``pkg.nd.<name>`` on ``ctx`` with its canonical op's case."""
    canonical = pkg.ops.registry.get_op(name).name
    fn = getattr(pkg.nd, name)
    kw = {"shape": shape}
    if dtype is not None:
        kw["dtype"] = dtype
    if canonical == "_sample_multinomial":
        return fn(pkg.nd.array(PROBS, ctx=ctx), **kw)
    if canonical == "_shuffle":
        return fn(pkg.nd.array(SHUFFLED, ctx=ctx))
    spec = SPECS[canonical][case]
    if "attrs" in spec:
        return fn(ctx=ctx, **spec["attrs"], **kw)
    return fn(*[pkg.nd.array(np.asarray(p, np.float32), ctx=ctx)
                for p in spec["params"]], **kw)


def rows_of(x, spec):
    """The draws per parameter row (one row for a scalar case)."""
    x = np.asarray(x, np.float64)
    return [x.ravel()] if "attrs" in spec else list(
        x.reshape(len(spec["mean"]), -1))


def support_ok(canonical, x, case=0):
    if not np.isfinite(x).all():
        return False
    if canonical not in SPECS:
        return True
    spec = SPECS[canonical][case]
    kind = spec["support"]
    if kind[0] == "range":
        return x.min() >= kind[1] and x.max() < kind[2]
    if kind[0] == "integer":
        return (x == np.round(x)).all() and x.min() >= kind[1] \
            and x.max() < kind[2]
    if kind[0] == "count":
        return (x == np.round(x)).all() and x.min() >= 0
    if kind[0] == "positive":
        return x.min() > 0
    if kind[0] == "nonnegative":
        return x.min() >= 0
    if kind[0] == "rows":
        lo, hi = spec["params"]
        return all(row.min() >= a and row.max() < b
                   for row, a, b in zip(rows_of(x, spec), lo, hi))
    return True


def moments(x, mean, var):
    """(ok, the mean's and the variance's distance in standard errors)."""
    n = x.size
    z_mean = abs(x.mean() - mean) / np.sqrt(var / n)
    m4 = ((x - x.mean()) ** 4).mean()
    se_var = np.sqrt(max(m4 - x.var() ** 2, 1e-300) / n)
    z_var = abs(x.var() - var) / se_var
    return z_mean < SIGMAS and z_var < SIGMAS, z_mean, z_var
