"""The port's HTTP service (``d2r_tpu_torch/server.py``) on the CPU, held
to the JAX package's ``d2r_tpu/server.py`` and to the cases of
``tests/test_server.py``: the micro-batcher, preprocessing (JAX's arrays bit
for bit), counters and their Prometheus text, the bulk path, hot reload,
the size limits, config resolution, and the HTTP service built by the same
code as ``python -m d2r_tpu_torch.server`` (``build_service``) beside the
JAX package's service on the same weights: probabilities within 1e-4."""

import base64
import concurrent.futures as cf
import dataclasses
import http.client
import io
import json
import threading
import time
import urllib.error
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from d2r_tpu import server as jserver
from d2r_tpu.config import save_config_json as jax_save_config_json
from d2r_tpu.config import tiny_test_config as jax_tiny_config
from d2r_tpu.data.tokenizer import load_tokenizer as jax_load_tokenizer
from d2r_tpu.serve import Predictor as JaxPredictor
from d2r_tpu_torch import server
from d2r_tpu_torch.config import D2RConfig, tiny_test_config
from d2r_tpu_torch.data.tokenizer import load_tokenizer
from d2r_tpu_torch.server import InferenceService, MicroBatcher, ServiceStats
from tests.test_torch_serve import tiny_checkpoint, tiny_tree


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jpeg(seed, size=32):
    rng = np.random.default_rng(seed)
    buf = io.BytesIO()
    Image.fromarray(rng.integers(0, 256, (size, size + 7, 3)).astype(np.uint8)).save(buf, "JPEG")
    return buf.getvalue()


# ---------------------------------------------------------------- batcher
def test_concurrent_submits_coalesce_into_one_flush():
    calls = []

    def run(items):
        calls.append(len(items))
        return [i * 10 for i in items]

    mb = MicroBatcher(run, max_batch=8, max_wait_ms=200.0)
    try:
        with cf.ThreadPoolExecutor(4) as pool:
            futs = list(pool.map(lambda i: mb.submit(i), range(4)))
        results = [f.result(timeout=5) for f in futs]
    finally:
        mb.close()
    assert results == [0, 10, 20, 30]
    assert sum(calls) == 4 and len(calls) <= 2


def test_max_batch_splits_flushes():
    calls = []
    mb = MicroBatcher(lambda items: (calls.append(len(items)), items)[1],
                      max_batch=2, max_wait_ms=50.0)
    try:
        futs = [mb.submit(i) for i in range(5)]
        assert [f.result(timeout=5) for f in futs] == list(range(5))
    finally:
        mb.close()
    assert max(calls) <= 2 and sum(calls) == 5


def test_flush_error_fails_only_that_flush():
    state = {"fail": True}

    def run(items):
        if state["fail"]:
            state["fail"] = False
            raise RuntimeError("boom")
        return items

    mb = MicroBatcher(run, max_batch=4, max_wait_ms=10.0)
    try:
        with pytest.raises(RuntimeError, match="boom"):
            mb.submit("a").result(timeout=5)
        assert mb.submit("b").result(timeout=5) == "b"
    finally:
        mb.close()


def test_low_qps_flushes_after_probe_not_max_wait():
    mb = MicroBatcher(lambda items: items, max_batch=8, max_wait_ms=400.0)  # probe 40 ms
    try:
        t0 = time.monotonic()
        assert mb.submit("solo").result(timeout=5) == "solo"
        elapsed = time.monotonic() - t0
    finally:
        mb.close()
    assert elapsed < 0.25, f"lone request waited {elapsed * 1e3:.0f} ms"


def test_follower_in_probe_extends_to_full_window():
    calls = []
    mb = MicroBatcher(lambda items: (calls.append(len(items)), items)[1],
                      max_batch=4, max_wait_ms=500.0)  # probe 50 ms
    try:
        f0 = mb.submit(0)
        time.sleep(0.02)
        f1 = mb.submit(1)
        time.sleep(0.15)
        f2 = mb.submit(2)
        assert [f.result(timeout=5) for f in (f0, f1, f2)] == [0, 1, 2]
    finally:
        mb.close()
    assert calls and calls[0] == 3, calls


def test_submit_after_close_raises():
    mb = MicroBatcher(lambda items: items, max_batch=2, max_wait_ms=1.0)
    mb.close()
    with pytest.raises(RuntimeError):
        mb.submit(1)


# ------------------------------------------------------- preprocessing
class _FakePredictor:
    """Just enough Predictor surface for InferenceService: constant
    probabilities, or a raise (a device error) when ``fail`` is set."""

    def __init__(self, cfg, probs=(1 / 3, 1 / 3, 1 / 3), fail=None):
        self.cfg = cfg
        self.seq_len = cfg.max_seq
        self.batch_buckets = [4]
        self._probs = np.asarray(probs, np.float32)
        self.fail = fail

    def predict(self, input_ids, attention_mask, token_type_ids, pixel_values):
        if self.fail is not None:
            raise self.fail
        probs = np.tile(self._probs, (input_ids.shape[0], 1))
        return {"label": probs.argmax(-1), "probs": probs}


def _services(raw_uint8=True, **kw):
    """The port's and the JAX package's services over fake predictors."""
    cfg, jcfg = tiny_test_config(), jax_tiny_config()
    tok = load_tokenizer("nonexistent-tiny", vocab_size=cfg.text_config().vocab_size)
    jtok = jax_load_tokenizer("nonexistent-tiny", vocab_size=jcfg.text_config().vocab_size)
    return (InferenceService(_FakePredictor(cfg), tok, raw_uint8=raw_uint8, **kw),
            jserver.InferenceService(_FakePredictor(jcfg), jtok, raw_uint8=raw_uint8, **kw))


@pytest.mark.parametrize("raw_uint8", [True, False], ids=["uint8", "float32"])
@pytest.mark.parametrize("image", ["none", "jpeg", "png", "corrupt"])
def test_preprocess_gives_jax_arrays_bit_for_bit(image, raw_uint8, tmp_path):
    """Text with no image (the placeholder), a JPEG, a lossless PNG, and
    bytes that decode to nothing (the fallback image, then grey)."""
    payload = {"none": None, "jpeg": _jpeg(1), "corrupt": b"definitely not an image"}
    if image == "png":
        buf = io.BytesIO()
        Image.fromarray(np.random.default_rng(2).integers(0, 256, (40, 52, 3)).astype(np.uint8)
                        ).save(buf, "PNG")
        payload["png"] = buf.getvalue()
    fallback = str(tmp_path / "inf.png")
    Image.fromarray(np.full((20, 20, 3), 90, np.uint8)).save(fallback)
    for fb in (None, fallback):
        svc, jsvc = _services(raw_uint8=raw_uint8, fallback_image=fb)
        try:
            text = "What a GREAT day, isn't it? #sunny @friend https://x.y/z"
            got = svc.preprocess(text, payload[image])
            ref = jsvc.preprocess(text, payload[image])
            assert set(got) == set(ref)
            for k in ref:
                assert got[k].dtype == ref[k].dtype and got[k].shape == ref[k].shape, k
                np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
        finally:
            svc.close()
            jsvc.close()


# ----------------------------------------------------- counters, bulk path
def test_stats_snapshot_and_prometheus_text_match_jax():
    stats, jstats = ServiceStats(), jserver.ServiceStats()
    for s in (stats, jstats):
        for i in range(50):
            s.record_request(float(i % 7) + 0.5, ok=i % 9 != 0)
        for n in (1, 4, 4, 2):
            s.record_flush(n)
        s.record_reload()
    snap, jsnap = stats.snapshot(), jstats.snapshot()
    jsnap["uptime_s"] = snap["uptime_s"]
    assert snap == jsnap
    assert server.prometheus_text(snap) == jserver.prometheus_text(snap)
    assert server.prometheus_text(ServiceStats().snapshot()).startswith("# HELP d2r_uptime")


def test_predict_many_preprocesses_all_items_before_first_submit():
    svc, jsvc = _services()
    jsvc.close()
    try:
        order = []
        real_pre, real_submit = svc.preprocess, svc.batcher.submit
        svc.preprocess = lambda t, i: (order.append("pre"), real_pre(t, i))[1]
        svc.batcher.submit = lambda item: (order.append("submit"), real_submit(item))[1]
        assert len(svc.predict_many([("a", None), ("b", None), ("c", None)])) == 3
        assert order == ["pre"] * 3 + ["submit"] * 3
    finally:
        svc.close()


@pytest.mark.parametrize("fail_at", ["preprocess", "one_item"])
def test_predict_many_counts_failures_per_item(fail_at):
    svc, jsvc = _services()
    jsvc.close()
    try:
        if fail_at == "preprocess":
            def boom(text, image_bytes):
                raise RuntimeError("preprocess boom")
            svc.preprocess = boom
        else:
            calls = []

            def submit(item):
                f = cf.Future()
                if len(calls) == 1:
                    f.set_exception(RuntimeError("boom"))
                else:
                    f.set_result({"label": 0, "probs": [1.0, 0.0]})
                calls.append(item)
                return f
            svc.batcher.submit = submit
        with pytest.raises(RuntimeError, match="boom"):
            svc.predict_many([("a", None)] * 3)
        snap = svc.stats.snapshot()
        assert snap["requests_total"] == 3
        assert snap["errors_total"] == (3 if fail_at == "preprocess" else 1)
    finally:
        svc.close()


def test_a_device_error_reaches_every_caller_and_the_service_keeps_serving():
    """A CUDA error raised by the predictor is not swallowed: predict_one and
    predict_many raise it, it counts as an error, and the next flush runs."""
    cfg = tiny_test_config()
    tok = load_tokenizer("nonexistent-tiny", vocab_size=cfg.text_config().vocab_size)
    pred = _FakePredictor(cfg, fail=RuntimeError("CUDA error: an illegal memory access"))
    svc = InferenceService(pred, tok)
    try:
        with pytest.raises(RuntimeError, match="CUDA error"):
            svc.predict_one("x")
        with pytest.raises(RuntimeError, match="CUDA error"):
            svc.predict_many([("a", None), ("b", None)])
        assert svc.stats.snapshot()["errors_total"] == 3
        pred.fail = None
        assert svc.predict_one("x")["probs"] == pytest.approx([1 / 3] * 3)
    finally:
        svc.close()


def test_reload_swaps_guards_geometry_and_refuses_a_second_reload():
    cfg = tiny_test_config()
    tok = load_tokenizer("nonexistent-tiny", vocab_size=cfg.text_config().vocab_size)
    built = {}

    def factory(load_path):
        if load_path == "wrong-seq":
            return _FakePredictor(tiny_test_config(max_seq=cfg.max_seq * 2), [1, 0, 0])
        if load_path == "device-error":
            raise RuntimeError("CUDA error: out of memory")
        built["path"] = load_path
        return _FakePredictor(cfg, [0, 0, 1])

    svc = InferenceService(_FakePredictor(cfg, [1, 0, 0]), tok, predictor_factory=factory)
    try:
        assert svc.predict_one("x")["label"] == 0
        svc.reload("ckpt-b")
        assert built["path"] == "ckpt-b" and svc.predict_one("x")["label"] == 2
        assert svc.stats.snapshot()["reloads_total"] == 1
        with pytest.raises(ValueError, match="max_seq"):
            svc.reload("wrong-seq")
        with pytest.raises(RuntimeError, match="CUDA error"):
            svc.reload("device-error")
        assert svc.predict_one("x")["label"] == 2          # the old model kept
        with svc._reload_lock:
            with pytest.raises(BlockingIOError):
                svc.reload("ckpt-c")
    finally:
        svc.close()
    svc, jsvc = _services()
    jsvc.close()
    try:
        with pytest.raises(RuntimeError, match="not configured"):
            svc.reload("anywhere")
    finally:
        svc.close()


# --------------------------------------------------------- configuration
def test_resolve_serve_config_reads_a_jax_config_json(tmp_path, capsys):
    """config.json beside best_model (written by the JAX package), flags over
    it, quant_train dropped, unknown overrides refused; a pipelined
    run's config resolves, and its checkpoint serves unpipelined with the
    answers of the same weights unpipelined."""
    jax_save_config_json(jax_tiny_config(quant_train="int8", max_seq=24),
                         str(tmp_path / "config.json"))
    load = str(tmp_path / "best_model")
    cfg = server.resolve_serve_config(load, DR_step=4)
    want = dataclasses.replace(tiny_test_config(max_seq=24), DR_step=4)
    assert cfg == want and cfg.quant_train == "none"
    assert "ignoring training-time quant_train" in capsys.readouterr().out
    with pytest.raises(ValueError, match="unexpected serve overrides"):
        server.resolve_serve_config(load, lr=1.0)
    with pytest.raises(FileNotFoundError):
        server.resolve_serve_config(load, config_json=str(tmp_path / "absent.json"))
    # a sentic model serves, as in the JAX package, without the GCN (no
    # adjacency reaches a served forward); the layout hints of a run with a
    # model axis serve (one process has none), and so does a pipelined run,
    # unpipelined (d2r_tpu/serve.py:41-55)
    jax_save_config_json(jax_tiny_config(use_sentic_graph=True), str(tmp_path / "config.json"))
    assert server.resolve_serve_config(load).use_sentic_graph
    jax_save_config_json(jax_tiny_config(seq_shard=True, fabric_shard=True, mesh_shape=(2, 2),
                                         mesh_axis_names=("data", "model")),
                         str(tmp_path / "config.json"))
    assert server.resolve_serve_config(load).seq_shard
    jax_save_config_json(jax_tiny_config(pipeline_stages=2, pipeline_microbatches=2),
                         str(tmp_path / "config.json"))
    piped = server.resolve_serve_config(load)
    assert (piped.pipeline_stages, piped.pipeline_microbatches) == (2, 2)
    from d2r_tpu_torch.serve import Predictor
    from d2r_tpu_torch.train.checkpoint import restore_model
    from tests.test_torch_serve import KEYS, batch
    ckpt_path = tiny_checkpoint(tmp_path / "piped")
    pred = Predictor(piped, restore_model(ckpt_path, piped, "cpu"), batch_buckets=(1, 4),
                     device="cpu")
    plain = Predictor(tiny_test_config(), restore_model(ckpt_path, tiny_test_config(), "cpu"),
                      batch_buckets=(1, 4), device="cpu")
    assert pred.cfg.pipeline_stages == 1 and pred.model.model.encoder_text_layers.stages == 1
    b = batch(tiny_test_config(), 3, seed=2)
    for n in (1, 3):
        got, want = (p.predict(*[b[k][:n] for k in KEYS]) for p in (pred, plain))
        np.testing.assert_array_equal(got["probs"], want["probs"])
    assert server.resolve_serve_config(str(tmp_path / "elsewhere" / "m")) == D2RConfig(
        **server._SERVE_DEFAULTS)


# ----------------------------------------------------------- HTTP e2e
def _post(url, payload, timeout=120):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"}, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _get(url):
    with urllib.request.urlopen(url, timeout=30) as r:
        return json.loads(r.read())


@pytest.fixture(scope="module")
def services(tmp_path_factory):
    """The port's service as ``main`` builds it (``--device cpu``, bucket 2)
    on a checkpoint of ``tiny_tree()``, and the JAX package's service on the
    same tree; plus a second checkpoint (another seed) to reload."""
    root = tmp_path_factory.mktemp("serve")
    load = tiny_checkpoint(root / "a")
    other = tiny_checkpoint(root / "b", seed=7)
    args = server.build_arg_parser().parse_args(
        ["--load_path", load, "--device", "cpu", "--port", "0", "--batch_buckets", "2",
         "--max_wait_ms", "20"])
    svc, httpd = server.build_service(args)
    jcfg = jax_tiny_config()
    jpred = JaxPredictor(jcfg, tiny_tree(), batch_buckets=(2,))
    jpred.warmup(pixel_dtype=jnp.uint8)
    jsvc = jserver.InferenceService(
        jpred, jax_load_tokenizer(jcfg.bert_name, vocab_size=jcfg.text_config().vocab_size),
        max_wait_ms=20.0)
    jhttpd = jserver.make_server(jsvc, "127.0.0.1", 0)
    threads = [threading.Thread(target=h.serve_forever, daemon=True) for h in (httpd, jhttpd)]
    for t in threads:
        t.start()
    url = lambda h: f"http://127.0.0.1:{h.server_address[1]}"
    yield {"url": url(httpd), "jax_url": url(jhttpd), "svc": svc, "load": load,
           "other": other}
    for h, s in ((httpd, svc), (jhttpd, jsvc)):
        h.shutdown()
        h.server_close()
        s.close()
    for t in threads:
        t.join(timeout=10)


PAYLOADS = {"text": {"text": "no image here"},
            "jpeg": {"text": "what a great sunny day", "image_b64": base64.b64encode(
                _jpeg(3)).decode()},
            "corrupt": {"text": "a broken upload", "image_b64": base64.b64encode(
                b"\xff\xd8 not really a jpeg").decode()}}


@pytest.mark.parametrize("kind", sorted(PAYLOADS))
def test_http_predict_matches_the_jax_service(services, kind):
    status, got = _post(services["url"] + "/predict", PAYLOADS[kind])
    jstatus, ref = _post(services["jax_url"] + "/predict", PAYLOADS[kind])
    assert status == jstatus == 200, (got, ref)
    assert got["label"] == ref["label"]
    np.testing.assert_allclose(got["probs"], ref["probs"], atol=1e-4, rtol=0)


def test_http_healthz_metrics_and_prometheus(services):
    url = services["url"]
    health = _get(url + "/healthz")
    assert health["status"] == "ok" and health["batch_buckets"] == [2]
    before = _get(url + "/metrics")
    assert _post(url + "/predict", PAYLOADS["text"])[0] == 200
    after = _get(url + "/metrics")
    assert after["requests_total"] == before["requests_total"] + 1
    assert after["flushes_total"] >= before["flushes_total"] + 1
    assert after["errors_total"] == before["errors_total"]
    assert 0 < after["latency_ms"]["p50"] <= after["latency_ms"]["p99"]
    assert after["batch_size"]["max"] <= 2
    req = urllib.request.Request(url + "/metrics", headers={
        "Accept": "application/openmetrics-text; version=1.0"})
    with urllib.request.urlopen(req, timeout=10) as r:
        assert r.headers["Content-Type"].startswith("text/plain")
        text = r.read().decode()
    assert "# TYPE d2r_requests_total counter" in text
    assert 'd2r_request_latency_ms{quantile="0.99"}' in text


def test_http_bad_requests_and_size_limits(services, monkeypatch):
    url = services["url"]
    status, body = _post(url + "/predict", {"not_text": 1})
    assert status == 400 and "text" in body["error"]
    host = url.split("//", 1)[1]
    for length, want in ((str(2 << 30), 413), ("-1", 400)):
        conn = http.client.HTTPConnection(host, timeout=30)
        try:
            conn.putrequest("POST", "/predict")
            conn.putheader("Content-Type", "application/json")
            conn.putheader("Content-Length", length)
            conn.endheaders()
            if want == 413:
                conn.send(b'{"text": "hi"}')
            resp = conn.getresponse()
            assert resp.status == want, resp.read()[:200]
        finally:
            conn.close()
    monkeypatch.setattr(server, "MAX_IMAGE_BYTES", 16)
    payload = {"text": "x", "image_b64": base64.b64encode(b"z" * 64).decode()}
    for path, body in (("/predict", payload), ("/predict_batch", {"items": [payload]})):
        status, out = _post(url + path, body)
        assert status == 413 and "image_b64" in out["error"]


def test_http_predict_batch_and_concurrent_requests(services):
    url = services["url"]
    texts = ["bulk one", "bulk two", "bulk one"]
    status, body = _post(url + "/predict_batch", {"items": [{"text": t} for t in texts]})
    assert status == 200 and len(body["results"]) == 3
    np.testing.assert_allclose(body["results"][0]["probs"], body["results"][2]["probs"],
                               atol=2e-5)
    _, single = _post(url + "/predict", {"text": "bulk one"})
    np.testing.assert_allclose(body["results"][0]["probs"], single["probs"], atol=2e-5)
    for bad, needle in (({"items": []}, "items"), ({"items": [{"text": "x"}] * 513}, "too many"),
                        ({"items": [{"text": "x"}, {"no_text": 1}]}, "text")):
        status, out = _post(url + "/predict_batch", bad)
        assert status == 400 and needle in out["error"]
    with cf.ThreadPoolExecutor(4) as pool:
        outs = list(pool.map(lambda _: _post(url + "/predict", {"text": "same"}), range(4)))
    assert all(s == 200 for s, _ in outs)
    probs = np.array([o["probs"] for _, o in outs])
    np.testing.assert_allclose(probs, np.broadcast_to(probs[0], probs.shape), atol=2e-5)


def test_http_reload_swaps_the_model_under_traffic(services):
    """POST /reload to another checkpoint changes the answers; a reload back
    while two clients keep posting loses no request. Runs last: it swaps
    the fixture's model."""
    url = services["url"]
    payload = {"text": "stable request for the swap check"}
    _, before = _post(url + "/predict", payload)
    status, body = _post(url + "/reload", {"not_load_path": 1})
    assert status == 400 and "load_path" in body["error"]
    status, body = _post(url + "/reload", {"load_path": services["other"]})
    assert status == 200 and body["status"] == "reloaded", body
    _, after = _post(url + "/predict", payload)
    assert not np.allclose(before["probs"], after["probs"], atol=1e-6)

    stop, codes, errors = threading.Event(), [], []

    def hammer():
        while not stop.is_set():
            status, body = _post(url + "/predict", {"text": "load during swap"}, timeout=300)
            codes.append(status)
            if status != 200:
                errors.append(body)

    threads = [threading.Thread(target=hammer) for _ in range(2)]
    for t in threads:
        t.start()
    try:
        time.sleep(0.3)
        status, body = _post(url + "/reload", {"load_path": services["load"]}, timeout=300)
        assert status == 200, body
        time.sleep(0.3)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=300)
    assert not any(t.is_alive() for t in threads)
    assert not errors and len(codes) >= 2 and all(c == 200 for c in codes)
    _, back = _post(url + "/predict", payload)
    np.testing.assert_allclose(back["probs"], before["probs"], atol=1e-6)
    assert _get(url + "/metrics")["reloads_total"] == 2


def test_http_a_device_error_answers_500(services):
    """A failing forward answers 500 with the error and counts it; the
    service answers the next request."""
    svc = services["svc"]
    real = svc.predictor
    svc.predictor = _FakePredictor(real.cfg, fail=RuntimeError("CUDA error: device-side assert"))
    try:
        before = svc.stats.snapshot()["errors_total"]
        status, body = _post(services["url"] + "/predict", {"text": "x"})
        assert status == 500 and "CUDA error" in body["error"]
        assert svc.stats.snapshot()["errors_total"] == before + 1
    finally:
        svc.predictor = real
    assert _post(services["url"] + "/predict", {"text": "x"})[0] == 200
