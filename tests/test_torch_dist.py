"""The port's ``dist_sync`` store across two processes over gloo.

One job of two CPU workers, started by the unchanged ``tools/launch.py``
as ``test_dist_multiprocess.py::test_tools_launch_local`` starts the JAX
package's: push/pull sums, ``push_pull_list`` plain and under 2-bit
compression against the single-process sums, and an MLP fit with
``dist_sync`` against the single-process two-context ``'device'`` run
over the same batches split the same way (within 1e-6).  The job runs
once for the file (a module fixture), on a free port, under a hard
timeout that kills the whole process group and prints every rank's
output; a port taken before rank 0 binds it is retried, at most 3
spawns in all.
"""
import json
import os
import signal
import socket
import subprocess
import sys

import numpy as np
import pytest

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.kvstore import gradient_compression as gc

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 150
SPAWNS = 3
THRESHOLD = 0.5

_WORKER = r"""
import json, os, sys
import numpy as np
import mxnet_tpu_torch as mx

out_dir = sys.argv[1]
ctx = mx.cpu()
kv = mx.kv.create("dist_sync")
rank, size = kv.rank, kv.num_workers
res = {"rank": rank, "size": size}

kv.init("w", mx.nd.zeros((3,), ctx=ctx))
kv.push("w", mx.nd.ones((3,), ctx=ctx) * (rank + 1))
out = mx.nd.zeros((3,), ctx=ctx)
kv.pull("w", out=out)
res["sum"] = out.asnumpy().tolist()
kv.barrier()

rng = np.random.RandomState(10 + rank)
vals = [rng.standard_normal((2, 3)).astype(np.float32),
        rng.standard_normal(5).astype(np.float32),
        rng.standard_normal(4).astype(np.float64)]
keys = ["pa", "pb", "pc"]
arrays = []
for k, v in zip(keys, vals):
    kv.init(k, mx.nd.zeros(v.shape, ctx=ctx, dtype=v.dtype))
    arrays.append(mx.nd.array(v, ctx=ctx, dtype=v.dtype))
kv.push_pull_list(keys, arrays, arrays)
res["list"] = [a.asnumpy().tolist() for a in arrays]
res["backend"] = kv.backend

kv2 = mx.kv.create("dist_sync")
kv2.set_gradient_compression({"type": "2bit", "threshold": 0.5})
ckeys = ["ca", "cb"]
kv2.init("ca", mx.nd.zeros((3,), ctx=ctx))
kv2.init("cb", mx.nd.zeros((7,), ctx=ctx))
res["compressed"] = []
for step in range(2):
    rng = np.random.RandomState(20 + 2 * rank + step)
    grads = [mx.nd.array(rng.standard_normal(n).astype(np.float32), ctx=ctx)
             for n in (3, 7)]
    outs = [mx.nd.zeros(g.shape, ctx=ctx) for g in grads]
    kv2.push_pull_list(ckeys, grads, outs)
    res["compressed"].append([o.asnumpy().tolist() for o in outs])
res["wire"] = kv2.wire_bytes_pushed

data = np.load(os.path.join(out_dir, "task.npz"))
half = int(data["batch"]) // 2
rows = np.concatenate([np.arange(half) + b * 2 * half + rank * half
                       for b in range(len(data["x"]) // (2 * half))])
net = mx.sym.SoftmaxOutput(mx.sym.FullyConnected(mx.sym.Activation(
    mx.sym.FullyConnected(mx.sym.var("data"), num_hidden=16, name="fc1"),
    act_type="relu"), num_hidden=4, name="fc2"), name="softmax")
mod = mx.mod.Module(net, context=ctx)
mod.fit(mx.io.NDArrayIter(data["x"][rows], data["y"][rows],
                          batch_size=half),
        num_epoch=2, kvstore="dist_sync", optimizer="sgd",
        optimizer_params={"learning_rate": 0.1, "momentum": 0.9},
        arg_params={k[4:]: mx.nd.array(data[k], ctx=ctx)
                    for k in data.files if k.startswith("arg:")})
res["update_on_kvstore"] = mod._update_on_kvstore
np.savez(os.path.join(out_dir, "params%d.npz" % rank),
         **{k: v.asnumpy() for k, v in mod.get_params()[0].items()})
with open(os.path.join(out_dir, "rank%d.json" % rank), "w") as f:
    json.dump(res, f)
print("WORKER_OK rank=%d/%d" % (rank, size), flush=True)
"""


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _task():
    r = np.random.RandomState(0)
    x = r.standard_normal((64, 6)).astype(np.float32)
    y = np.argmax(x @ r.standard_normal((6, 4)), axis=1).astype(np.float32)
    weights = {"fc1_weight": 0.5 * r.standard_normal((16, 6)),
               "fc1_bias": 0.1 * r.standard_normal(16),
               "fc2_weight": 0.5 * r.standard_normal((4, 16)),
               "fc2_bias": 0.1 * r.standard_normal(4)}
    return x, y, {k: v.astype(np.float32) for k, v in weights.items()}


def _launch(out_dir):
    """One two-worker job: (exit code, output)."""
    script = os.path.join(out_dir, "worker.py")
    with open(script, "w") as f:
        f.write(_WORKER)
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    proc = subprocess.Popen(
        [sys.executable, os.path.join(REPO, "tools", "launch.py"), "-n", "2",
         "--port", str(_free_port()), "--", sys.executable, script,
         out_dir],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env, cwd=REPO, start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=TIMEOUT_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, _ = proc.communicate(timeout=10)
        raise AssertionError("the two workers did not finish in %d s; the "
                             "process group was killed; output:\n%s"
                             % (TIMEOUT_S, out))
    return proc.returncode, out


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    out_dir = str(tmp_path_factory.mktemp("dist"))
    x, y, weights = _task()
    np.savez(os.path.join(out_dir, "task.npz"), x=x, y=y, batch=16,
             **{"arg:" + k: v for k, v in weights.items()})
    for _ in range(SPAWNS):
        rc, out = _launch(out_dir)
        if rc == 0 or "Address already in use" not in out:
            break
    assert rc == 0 and out.count("WORKER_OK") == 2, out
    ranks = []
    for r in range(2):
        with open(os.path.join(out_dir, "rank%d.json" % r)) as f:
            ranks.append(json.load(f))
        ranks[-1]["params"] = dict(np.load(os.path.join(
            out_dir, "params%d.npz" % r)))
    return ranks


def test_ranks_and_the_gloo_backend(job):
    assert [r["rank"] for r in job] == [0, 1]
    assert all(r["size"] == 2 for r in job)
    assert all(r["backend"] == "gloo" for r in job)
    assert all(r["update_on_kvstore"] for r in job)


def test_push_pull_sums_over_the_processes(job):
    for r in job:
        np.testing.assert_array_equal(r["sum"], [3.0, 3.0, 3.0])


def test_push_pull_list_against_the_single_process_sum(job):
    drawn = []
    for rank in range(2):
        rng = np.random.RandomState(10 + rank)
        drawn.append([rng.standard_normal(s).astype(dt) for s, dt in
                      (((2, 3), np.float32), ((5,), np.float32),
                       ((4,), np.float64))])
    want = [a + b for a, b in zip(*drawn)]
    for r in job:
        for got, w in zip(r["list"], want):
            np.testing.assert_allclose(got, w, rtol=1e-6, atol=1e-6)


def test_compressed_push_pull_list_against_the_single_process_sum(job):
    """Each rank's codes, with its residual carried over two pushes, then
    every rank's codes summed: equal to the host quantizer's; 3 + 7 values
    cross as ceil(3/4) + ceil(7/4) = 3 bytes a push."""
    import torch
    residual = {(rank, n): torch.zeros(n) for rank in range(2)
                for n in (3, 7)}
    for step in range(2):
        want = []
        rows = {n: [] for n in (3, 7)}
        for rank in range(2):
            rng = np.random.RandomState(20 + 2 * rank + step)
            for n in (3, 7):
                g = torch.from_numpy(rng.standard_normal(n).astype(
                    np.float32))
                codes, residual[(rank, n)] = gc.quantize_flat(
                    g, residual[(rank, n)], THRESHOLD)
                rows[n].append(codes)
        for n in (3, 7):
            want.append(gc.dequantize_sum_flat(torch.stack(rows[n]), n,
                                               THRESHOLD).numpy())
        for r in job:
            for got, w in zip(r["compressed"][step], want):
                np.testing.assert_array_equal(got, w)
    assert all(r["wire"] == 6 for r in job)


def test_mlp_fit_matches_the_single_process_two_context_run(job):
    """Two ranks at 8 images a step with dist_sync against one process
    over [cpu(0), cpu(1)] at 16 with 'device', the same halves on the same
    contexts: within 1e-6, and the ranks bit for bit."""
    x, y, weights = _task()
    net = mt.sym.SoftmaxOutput(mt.sym.FullyConnected(mt.sym.Activation(
        mt.sym.FullyConnected(mt.sym.var("data"), num_hidden=16,
                              name="fc1"), act_type="relu"),
        num_hidden=4, name="fc2"), name="softmax")
    mod = mt.mod.Module(net, context=[mt.cpu(0), mt.cpu(1)])
    mod.fit(mt.io.NDArrayIter(x, y, batch_size=16), num_epoch=2,
            kvstore="device", optimizer="sgd",
            optimizer_params={"learning_rate": 0.1, "momentum": 0.9},
            arg_params={k: mt.nd.array(v, ctx=mt.cpu())
                        for k, v in weights.items()})
    want = {k: v.asnumpy() for k, v in mod.get_params()[0].items()}
    for k, w in want.items():
        np.testing.assert_array_equal(job[0]["params"][k],
                                      job[1]["params"][k])
        np.testing.assert_allclose(job[0]["params"][k], w, rtol=1e-6,
                                   atol=1e-6, err_msg=k)
        assert not np.allclose(w, weights[k])


def test_rank_and_size_from_the_dmlc_environment(monkeypatch):
    """Without a process group, ``rank``/``num_workers`` read the
    reference's DMLC_* variables and reductions stay local."""
    for var in ("JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES",
                "JAX_PROCESS_ID"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("DMLC_WORKER_ID", "3")
    monkeypatch.setenv("DMLC_NUM_WORKER", "5")
    kv = mt.kv.create("dist_sync")
    assert (kv.rank, kv.num_workers) == (3, 5)
    kv.init(0, mt.nd.zeros((2,), ctx=mt.cpu()))
    kv.push(0, mt.nd.full((2,), 4.0, ctx=mt.cpu()))
    out = mt.nd.zeros((2,), ctx=mt.cpu())
    kv.pull(0, out=out)
    np.testing.assert_array_equal(out.asnumpy(), [4.0, 4.0])
    kv.barrier()


def test_server_role_parks_until_its_parent_exits():
    """A process launched as DMLC_ROLE=server parks at import while its
    parent lives and exits when the parent goes (the reference's server
    loop at import): the parent outlives the child's import by a few
    seconds, the run returns once the parked child closes the output it
    inherited, and the child never got past the import."""
    script = ("import os, subprocess, sys, time\n"
              "child = subprocess.Popen([sys.executable, '-c', "
              "'import mxnet_tpu_torch; print(\"UNREACHED\")'], "
              "env=dict(os.environ, DMLC_ROLE='server'))\n"
              "time.sleep(12)\n"
              "print('PARENT_DONE', child.poll(), flush=True)\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run([sys.executable, "-c", script], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=90)
    assert out.returncode == 0 and "PARENT_DONE None" in out.stdout
    assert "UNREACHED" not in out.stdout
