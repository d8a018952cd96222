"""Serving over a mesh on the CPU: the port's ``Predictor(mesh=...)`` over
``parallel.launch.spawn`` (gloo, one process a rank) at (data) = (2,) and
(data, model) = (2, 2), held to the JAX package's mesh ``Predictor`` at the
same shapes (its 8-device CPU mesh, as ``tests/test_serve.py`` builds it)
and to the port's one-process predictor; and ``python -m
d2r_tpu_torch.server --dp 2`` answering, reloading and failing a flush
whose follower died, against one process.

Buckets (2, 3): 2 divides the data axis (each data rank runs one row of
it), 3 does not (every data rank runs the whole bucket); requests of 1, 2,
3 and 5 rows (5 chunked as 3 + 2). Tolerances (fp32): against the JAX
predictor atol 1e-4, as the one-process predictor is held
(``tests/test_torch_serve.py``); against the port's one-process predictor
atol 1e-5 (the same math, other batch shapes and a model axis's partial
sums); across the ranks of a mesh, bit for bit.
"""

import functools
import json
import os
import re
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from d2r_tpu.config import tiny_test_config as jax_tiny_config
from d2r_tpu.parallel.mesh import make_mesh as jax_make_mesh
from d2r_tpu.serve import Predictor as JaxPredictor
from d2r_tpu_torch import server
from d2r_tpu_torch.config import tiny_test_config
from d2r_tpu_torch.parallel.launch import REPO, spawn
from d2r_tpu_torch.serve import Predictor
from d2r_tpu_torch.weights import from_jax_variables
from tests import test_torch_parallel_ranks as ranks
from tests.test_torch_model import batch
from tests.test_torch_serve import KEYS, tiny_checkpoint, tiny_tree


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: beside the suite's other workers torch's
    default threads contend, and the tiny steps run many times slower."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

BUCKETS = (2, 3)
ROWS = (1, 2, 3, 5)
MESHES = [(2,), (2, 2)]
JAX_TOL, TOL = 1e-4, 1e-5


@functools.lru_cache(maxsize=None)
def _requests():
    b = batch(tiny_test_config(), max(ROWS), seed=3)
    return [[b[k][:n] for k in KEYS] for n in ROWS]


@functools.lru_cache(maxsize=None)
def _one_process(quantize=None):
    cfg = tiny_test_config()
    pred = Predictor(cfg, from_jax_variables(cfg, tiny_tree()), batch_buckets=BUCKETS,
                     device="cpu", quantize=quantize)
    return [pred.predict(*r)["probs"] for r in _requests()]


@functools.lru_cache(maxsize=None)
def _mesh_runs(shape):
    return spawn(ranks.serve_rank, int(np.prod(shape)),
                 (shape, tiny_tree(), _requests(), BUCKETS, (None, "int8")))


def _ids(shape):
    return "x".join(map(str, shape))


@pytest.mark.parametrize("shape", MESHES, ids=_ids)
def test_mesh_predictor_matches_the_jax_mesh_predictor(shape):
    axes = ("data", "model")[:len(shape)]
    jpred = JaxPredictor(jax_tiny_config(), tiny_tree(), batch_buckets=BUCKETS,
                         mesh=jax_make_mesh(shape, axes))
    got = _mesh_runs(shape)[0]["probs"][None]
    for request, probs in zip(_requests(), got):
        want = np.asarray(jpred.predict(*request)["probs"], np.float32)
        np.testing.assert_allclose(probs, want, atol=JAX_TOL, rtol=0)


@pytest.mark.parametrize("quantize", [None, "int8"])
@pytest.mark.parametrize("shape", MESHES, ids=_ids)
def test_mesh_predictor_matches_one_process(shape, quantize):
    """Every rank returns the whole answer, the same bits on every rank,
    within 1e-5 of one process's (int8: of one process's int8 predictor,
    the codes and scales cut as the dense weights); under a model axis
    each rank holds its share of the QKV features."""
    runs = _mesh_runs(shape)
    tp = shape[1] if len(shape) > 1 else 1
    for run in runs:
        assert run["qkv_hidden"] == 64 // tp
        for probs, first in zip(run["probs"][quantize], runs[0]["probs"][quantize]):
            assert np.array_equal(probs, first)
    for probs, want in zip(runs[0]["probs"][quantize], _one_process(quantize)):
        assert probs.shape == want.shape
        np.testing.assert_allclose(probs, want, atol=TOL, rtol=0)
        assert np.array_equal(probs.argmax(-1), want.argmax(-1))


# ---- server.py --dp / --tp ---------------------------------------------------

def post(url, payload, timeout=120):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"}, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


class ServerProcess:
    """``python -m d2r_tpu_torch.server`` with ``argv`` on the CPU, an
    ephemeral port, bucket 2: ``url`` once it serves, ``followers`` the
    pids of its follower ranks. ``stop`` sends Ctrl-C and returns the exit
    code."""

    def __init__(self, argv):
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "d2r_tpu_torch.server", "--device", "cpu", "--port", "0",
             "--batch_buckets", "2", "--max_wait_ms", "20", *argv],
            stdout=subprocess.PIPE, text=True, cwd=REPO,
            env=dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1"))
        self.followers, self.url = [], None
        for line in self.proc.stdout:
            found = re.search(r"followers \[([\d, ]*)\]", line)
            if found:
                self.followers = [int(p) for p in found.group(1).split(",")]
            found = re.search(r"serving on (http://\S+)", line)
            if found:
                self.url = found.group(1)
                break
        if self.url is None:
            self.proc.kill()
            raise RuntimeError(f"the server exited with {self.proc.wait()} before serving")
        # the ranks' later lines, read so that the pipe never fills
        threading.Thread(target=self.proc.stdout.read, daemon=True).start()

    def stop(self, timeout=60) -> int:
        self.proc.send_signal(signal.SIGINT)
        try:
            return self.proc.wait(timeout=timeout)
        finally:
            if self.proc.poll() is None:
                self.proc.kill()
                self.proc.wait()


def one_process_service(load):
    """The one-process service ``main`` builds on the checkpoint ``load``
    (no HTTP needed: ``predict_one``)."""
    args = server.build_arg_parser().parse_args(
        ["--load_path", load, "--device", "cpu", "--port", "0", "--batch_buckets", "2",
         "--max_wait_ms", "20"])
    svc, httpd = server.build_service(args)
    httpd.server_close()
    return svc


def gone(pid, wait_s=10.0):
    """Wait until ``pid`` has exited (a zombie counts: its sockets are
    closed)."""
    status = f"/proc/{pid}/status"
    deadline = time.monotonic() + wait_s
    while time.monotonic() < deadline:
        try:
            with open(status) as f:
                if "\nState:\tZ" in f.read():
                    return
        except FileNotFoundError:
            return
        time.sleep(0.05)
    raise TimeoutError(f"process {pid} still runs")


POSTS = ({"text": "what a great sunny day"}, {"text": "no image here, alas"})


def same_answers(url, svc):
    """Each of :data:`POSTS` answers as the one-process service does."""
    for body in POSTS:
        status, got = post(url + "/predict", body)
        want = svc.predict_one(body["text"])
        assert status == 200 and got["label"] == want["label"], (got, want)
        np.testing.assert_allclose(got["probs"], want["probs"], atol=TOL, rtol=0)


def test_server_dp_answers_reloads_and_fails_a_flush_whose_follower_died(tmp_path):
    """``--dp 2``: a POST, then a /reload to another checkpoint, answered as
    one process answers each; then a follower killed: the next flush
    answers 500 with gloo's error about the lost peer, at once."""
    load = tiny_checkpoint(tmp_path / "a")
    other = tiny_checkpoint(tmp_path / "b", seed=7)
    svc = one_process_service(load)
    proc = ServerProcess(["--load_path", load, "--dp", "2"])
    try:
        assert len(proc.followers) == 1
        same_answers(proc.url, svc)
        assert post(proc.url + "/reload", {"load_path": other})[0] == 200
        svc.reload(other)
        same_answers(proc.url, svc)
        os.kill(proc.followers[0], signal.SIGKILL)
        gone(proc.followers[0])
        status, body = post(proc.url + "/predict", POSTS[0], timeout=150)
        assert status == 500 and "gloo" in body["error"], body
    finally:
        svc.close()
        proc.stop()
