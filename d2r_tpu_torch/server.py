"""HTTP serving (counterpart of ``d2r_tpu/server.py``): raw (text,
image-bytes) requests -> sentiment, over the port's ``serve.Predictor``.

  request threads ──> MicroBatcher (bounded queue, max_wait/max_batch)
                              │ one flush = one padded bucket: one CUDA
                              │ graph replay on the card
                      Predictor.predict (serve.py)
                              │
                      per-request futures resolved

* preprocessing is the training pipeline's: ``encode_text``
  (data/dataset.py) and the CLIP resize + corrupt-image fallback chain
  (data/image.py), so serving sees what training saw;
* micro-batching lets requests that arrive within ``max_wait_ms`` of each
  other share one bucket forward;
* the HTTP layer is stdlib ``ThreadingHTTPServer``: one OS thread per
  connection blocks on its future; the single batcher thread owns every
  forward, so the predictor's buffers need no locking across requests.

Endpoints:
  GET  /healthz            -> {"status": "ok", ...}
  GET  /metrics            -> request/error/flush counters, end-to-end
                              latency percentiles, batch-fill stats (JSON;
                              ?format=prometheus or an openmetrics/text
                              Accept header returns the Prometheus
                              exposition format)
  POST /predict            -> body {"text": str, "image_b64": optional str}
                              -> {"label": int, "probs": [...]}
  POST /predict_batch      -> body {"items": [<predict bodies>]}
                              -> {"results": [...]} (order-preserving; the
                              whole list is submitted to the micro-batcher
                              at once, so it shares forwards)
  POST /reload             -> body {"load_path": str}: hot-swap to a new
                              checkpoint of the SAME geometry (the new
                              predictor is built and its graphs captured
                              while the old one keeps serving, then swapped)

Run it as ``python -m d2r_tpu_torch.server --load_path <best_model>``
(``--device cpu`` for the CPU).

**Over a mesh** (``--dp``/``--tp``, the JAX server's flags): the JAX server
is one process over several chips; the port runs one process a card, so
it starts ``dp x tp`` processes itself, this one as rank 0 and the others
as followers (``python -m d2r_tpu_torch.server`` again, told their rank by
``FOLLOWER_ENV``), each on card ``rank % device_count``, joined under NCCL
where every rank has a card of its own and gloo otherwise. Every rank
builds the same mesh ``Predictor`` (``serve.py``). Rank 0 alone runs the
HTTP service and its ``MicroBatcher``; each flush it broadcasts to the
followers (the row count, the pixel dtype and the four arrays) before its
own forward, and ``/reload`` broadcasts the new path, after which every
rank rebuilds (flushes wait for the reload on a mesh: the ranks must run
their collectives in one order). Shutdown broadcasts the end of the
followers' loop. Rank 0's collectives wait at most :data:`SERVE_TIMEOUT`,
so a follower that dies or hangs makes its flushes fail with an error,
never hang.
"""

from __future__ import annotations

import argparse
import base64
import concurrent.futures as cf
import dataclasses
import datetime
import json
import os
import queue
import subprocess
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from d2r_tpu_torch.data.dataset import encode_text
from d2r_tpu_torch.data.image import decode_image_bytes, placeholder_pixels


class MicroBatcher:
    """Groups concurrent ``submit`` calls into batched ``run_batch`` calls.

    One daemon thread drains a queue: it blocks for the first request, then
    gathers follow-ups until ``max_batch`` items are in hand or
    ``max_wait_ms`` has elapsed since the first, then calls
    ``run_batch(items) -> results`` once and resolves each item's future.
    A failed flush fails only that flush's futures — the loop keeps serving.

    Adaptive low-QPS wait: paying the full ``max_wait_ms`` after EVERY first
    request is pure added latency when nobody else is coming (at low QPS the
    expected batch is 1). The gather is therefore two-phase: wait only
    ``probe_ms`` (default max_wait/10, >=1 ms) for a follower; only if one
    arrives inside the probe window does the gather extend to the full
    ``max_wait_ms`` deadline. Sporadic requests flush after ~probe_ms; bulk
    submissions (queue already non-empty) and genuine bursts (follower
    lands in the probe) still coalesce exactly as before. Stateless, so no
    QPS estimate can go stale. Set ``probe_ms=max_wait_ms`` to restore the
    fixed-window behaviour.
    """

    def __init__(self, run_batch: Callable[[List], List],
                 max_batch: int = 32, max_wait_ms: float = 5.0,
                 max_queue: int = 1024, probe_ms: Optional[float] = None):
        assert max_batch >= 1
        self._run = run_batch
        self.max_batch = max_batch
        self.max_wait = max_wait_ms / 1e3
        if probe_ms is None:
            probe_ms = max(1.0, max_wait_ms / 10.0)
        self.probe = min(probe_ms, max_wait_ms) / 1e3
        self._q: "queue.Queue" = queue.Queue(maxsize=max_queue)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="d2r-microbatcher")
        self._thread.start()

    def submit(self, item) -> "cf.Future":
        if self._stop.is_set():
            raise RuntimeError("MicroBatcher is closed")
        fut: "cf.Future" = cf.Future()
        self._q.put((item, fut))
        return fut

    def _loop(self):
        while not self._stop.is_set():
            try:
                first = self._q.get(timeout=0.05)
            except queue.Empty:
                continue
            if first is None:  # shutdown sentinel
                break
            batch = [first]
            now = time.monotonic()
            deadline = now + self.max_wait
            probe_deadline = now + self.probe
            while len(batch) < self.max_batch:
                # phase 1 (probe): until a follower shows up, only wait the
                # short probe window; phase 2: a follower arrived, gather to
                # the full max_wait deadline
                limit = deadline if len(batch) > 1 else probe_deadline
                remaining = limit - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    nxt = self._q.get(timeout=remaining)
                except queue.Empty:
                    break
                if nxt is None:
                    self._stop.set()
                    break
                batch.append(nxt)
            items = [b[0] for b in batch]
            futs = [b[1] for b in batch]
            try:
                results = self._run(items)
                assert len(results) == len(items)
                for f, r in zip(futs, results):
                    f.set_result(r)
            except Exception as e:  # noqa: BLE001 — fail THIS flush only
                for f in futs:
                    if not f.done():
                        f.set_exception(e)

    def close(self):
        self._stop.set()
        try:
            self._q.put_nowait(None)
        except queue.Full:
            pass
        self._thread.join(timeout=5.0)


class ServiceStats:
    """Thread-safe serving counters + bounded latency/batch reservoirs.

    Percentiles come from a deque of the most recent ``window`` samples —
    O(1) memory forever-up servers, and recent-window percentiles are what
    an operator actually wants (an hour-old capture spike shouldn't sit in
    p99 all day)."""

    WINDOW = 2048

    def __init__(self):
        from collections import deque
        self._lock = threading.Lock()
        self._t0 = time.time()
        self.requests_total = 0
        self.errors_total = 0
        self.flushes_total = 0
        self.reloads_total = 0
        self._latencies_ms = deque(maxlen=self.WINDOW)
        self._batch_sizes = deque(maxlen=self.WINDOW)

    def record_request(self, latency_ms: float, ok: bool) -> None:
        with self._lock:
            self.requests_total += 1
            if ok:
                self._latencies_ms.append(latency_ms)
            else:
                self.errors_total += 1

    def record_flush(self, batch_size: int) -> None:
        with self._lock:
            self.flushes_total += 1
            self._batch_sizes.append(batch_size)

    def record_reload(self) -> None:
        with self._lock:
            self.reloads_total += 1

    def snapshot(self) -> Dict:
        with self._lock:
            lat = sorted(self._latencies_ms)
            sizes = list(self._batch_sizes)
            out = {
                "uptime_s": time.time() - self._t0,
                "requests_total": self.requests_total,
                "errors_total": self.errors_total,
                "flushes_total": self.flushes_total,
                "reloads_total": self.reloads_total,
            }
        if lat:
            pick = lambda q: lat[min(int(q * len(lat)), len(lat) - 1)]
            out["latency_ms"] = {
                "count": len(lat), "p50": pick(0.50), "p90": pick(0.90),
                "p99": pick(0.99), "max": lat[-1],
            }
        if sizes:
            out["batch_size"] = {
                "mean": sum(sizes) / len(sizes), "max": max(sizes),
            }
        return out


def prometheus_text(snapshot: Dict) -> str:
    """Render a ServiceStats snapshot in the Prometheus exposition format
    (one scrape surface for standard monitoring stacks; the JSON twin stays
    at plain GET /metrics). Counters keep Prometheus naming (_total); the
    recent-window percentiles export as quantile-labelled gauges."""
    lines = [
        "# HELP d2r_uptime_seconds Seconds since the service started.",
        "# TYPE d2r_uptime_seconds gauge",
        f"d2r_uptime_seconds {snapshot['uptime_s']:.3f}",
    ]
    for name, help_ in (("requests", "prediction requests handled"),
                        ("errors", "requests that raised"),
                        ("flushes", "micro-batch device launches"),
                        ("reloads", "hot checkpoint reloads")):
        lines += [
            f"# HELP d2r_{name}_total Total {help_}.",
            f"# TYPE d2r_{name}_total counter",
            f"d2r_{name}_total {snapshot[f'{name}_total']}",
        ]
    lat = snapshot.get("latency_ms")
    if lat:
        lines += [
            "# HELP d2r_request_latency_ms End-to-end request latency "
            "(recent window).",
            "# TYPE d2r_request_latency_ms gauge",
        ]
        # standard Prometheus summary convention: quantile in [0, 1]
        for q, qv in (("p50", "0.5"), ("p90", "0.9"), ("p99", "0.99")):
            lines.append(
                f'd2r_request_latency_ms{{quantile="{qv}"}} '
                f"{lat[q]:.3f}")
        lines.append(f'd2r_request_latency_ms{{quantile="max"}} '
                     f"{lat['max']:.3f}")
        lines += [
            "# HELP d2r_request_latency_samples Latency samples in the "
            "window.",
            "# TYPE d2r_request_latency_samples gauge",
            f"d2r_request_latency_samples {lat['count']}",
        ]
    bs = snapshot.get("batch_size")
    if bs:
        lines += [
            "# HELP d2r_batch_fill_mean Mean micro-batch size "
            "(recent window).",
            "# TYPE d2r_batch_fill_mean gauge",
            f"d2r_batch_fill_mean {bs['mean']:.3f}",
            "# HELP d2r_batch_fill_max Max micro-batch size "
            "(recent window).",
            "# TYPE d2r_batch_fill_max gauge",
            f"d2r_batch_fill_max {bs['max']}",
        ]
    return "\n".join(lines) + "\n"


class InferenceService:
    """Raw-request preprocessing + micro-batched Predictor dispatch."""

    def __init__(
        self,
        predictor,                      # serve.Predictor
        tokenizer,                      # data/tokenizer.py BertTokenizer or
                                        # data/bpe.py RobertaBPETokenizer
                                        # (duck-typed: encode_ids + *_token_id)
        raw_uint8: bool = True,         # pixel_transfer='uint8' request path
        fallback_image: Optional[str] = None,
        max_wait_ms: float = 5.0,
        label_names: Optional[Sequence[str]] = None,
        predictor_factory: Optional[Callable[..., object]] = None,
        probe_ms: Optional[float] = None,  # MicroBatcher adaptive probe
    ):
        """``predictor_factory(load_path)`` enables POST /reload: it must
        return a fully-warmed Predictor for that checkpoint (``main`` wires
        one that re-runs its own restore+quantize+warmup pipeline)."""
        self.predictor = predictor
        self.tokenizer = tokenizer
        self.raw_uint8 = raw_uint8
        self.fallback_image = fallback_image
        self.max_seq = predictor.seq_len
        vc = predictor.cfg.vision_config()
        self.image_size = vc.image_size
        self.label_names = list(label_names) if label_names else None
        self.predictor_factory = predictor_factory
        self._reload_lock = threading.Lock()
        # over a mesh, rank 0's broadcasts to the followers (build_service)
        self.channel = None
        self.stats = ServiceStats()
        self.batcher = MicroBatcher(
            self._run_batch,
            max_batch=predictor.batch_buckets[-1],
            max_wait_ms=max_wait_ms, probe_ms=probe_ms)

    # -- preprocessing (training-pipeline twins) -----------------------
    def preprocess(self, text: str, image_bytes: Optional[bytes]
                   ) -> Dict[str, np.ndarray]:
        ids, mask, segs = encode_text(self.tokenizer, text, self.max_seq)
        if image_bytes:
            pixels = decode_image_bytes(
                image_bytes, self.image_size,
                fallback_path=self.fallback_image,
                raw_uint8=self.raw_uint8)
        else:
            pixels = placeholder_pixels(self.image_size, self.raw_uint8)
        return {"input_ids": ids, "attention_mask": mask,
                "token_type_ids": segs, "pixel_values": pixels}

    # -- batcher flush -> one bucket forward ---------------------------
    def _run_batch(self, items: List[Dict[str, np.ndarray]]) -> List[Dict]:
        self.stats.record_flush(len(items))
        stacked = {k: np.stack([it[k] for it in items]) for k in items[0]}
        out = self.predictor.predict(
            stacked["input_ids"], stacked["attention_mask"],
            stacked["token_type_ids"], stacked["pixel_values"])
        results = []
        for i in range(len(items)):
            r = {"label": int(out["label"][i]),
                 "probs": [float(p) for p in out["probs"][i]]}
            if self.label_names:
                r["label_name"] = self.label_names[r["label"]]
            results.append(r)
        return results

    # -- hot checkpoint reload -------------------------------------------
    def reload(self, load_path: str) -> None:
        """Swap in a new checkpoint with zero downtime.

        The factory builds AND WARMS the new predictor while the current one
        keeps serving (the batcher reads ``self.predictor`` per flush, so
        the attribute assignment is the atomic cutover; an in-flight flush
        finishes on the old model). Geometry is guarded twice: the factory's
        own config.json check, plus the seq/image guards here — the
        service's tokenizer and preprocessing are shared state, so a
        checkpoint that needs different ones must be a new server, not a
        reload."""
        if self.predictor_factory is None:
            raise RuntimeError(
                "hot reload is not configured (no predictor_factory)")
        if not self._reload_lock.acquire(blocking=False):
            raise BlockingIOError("another reload is already in progress")
        try:
            new = self.predictor_factory(load_path)
            if new.seq_len != self.max_seq:
                raise ValueError(
                    f"reload checkpoint max_seq {new.seq_len} != serving "
                    f"max_seq {self.max_seq}")
            vc = new.cfg.vision_config()
            if vc.image_size != self.image_size:
                raise ValueError(
                    f"reload checkpoint image_size {vc.image_size} != "
                    f"serving image_size {self.image_size}")
            self.predictor = new
            self.stats.record_reload()
        finally:
            self._reload_lock.release()

    # -- public entry ---------------------------------------------------
    def predict_one(self, text: str, image_bytes: Optional[bytes] = None,
                    timeout: Optional[float] = 30.0) -> Dict:
        t0 = time.monotonic()
        try:
            item = self.preprocess(text, image_bytes)
            result = self.batcher.submit(item).result(timeout=timeout)
        except Exception:
            self.stats.record_request((time.monotonic() - t0) * 1e3, ok=False)
            raise
        self.stats.record_request((time.monotonic() - t0) * 1e3, ok=True)
        return result

    def predict_many(self, requests: List[tuple],
                     timeout: Optional[float] = 120.0) -> List[Dict]:
        """Bulk path: preprocess everything, enqueue ALL futures before
        waiting on any (one client's list fills whole micro-batches instead
        of trickling through max_wait windows). ``requests`` is a list of
        (text, image_bytes-or-None); results keep the input order."""
        t0 = time.monotonic()
        # Preprocess EVERYTHING before the first submit: interleaving the
        # (slow, host-side) preprocessing with submission lets the
        # batcher's max_wait window expire between items and flushes
        # micro-batches of ~1, defeating the bulk path.
        try:
            items = [self.preprocess(text, img) for text, img in requests]
        except Exception:
            # the whole bulk request dies before any future exists: every
            # item counts as a failed request, matching the per-item
            # accounting of the submit path below
            per = (time.monotonic() - t0) * 1e3 / max(len(requests), 1)
            for _ in requests:
                self.stats.record_request(per, ok=False)
            raise
        futs = [self.batcher.submit(item) for item in items]
        results: List[Dict] = []
        first_err: Optional[BaseException] = None
        oks: List[bool] = []
        for f in futs:
            try:
                results.append(f.result(timeout=timeout))
                oks.append(True)
            except Exception as e:  # noqa: BLE001 — per-item accounting
                results.append({})
                oks.append(False)
                if first_err is None:
                    first_err = e
        per = (time.monotonic() - t0) * 1e3 / max(len(requests), 1)
        # attribute ok/error to the item that actually succeeded/failed
        for ok in oks:
            self.stats.record_request(per, ok=ok)
        if first_err is not None:
            raise first_err
        return results

    def close(self):
        """Stop the batcher and, over a mesh, end the followers."""
        self.batcher.close()
        if self.channel is not None:
            self.channel.close()


# Request-size limits: one hostile (or fat-fingered) request must not OOM
# the serving process. Body cap bounds what we read off the socket; the
# per-item cap bounds decoded image bytes handed to the decoders.
MAX_BODY_BYTES = 32 << 20       # 413 above this, body never read
MAX_IMAGE_BYTES = 16 << 20      # per-item decoded image_b64 cap, 413


class PayloadTooLarge(ValueError):
    """Request or item exceeds a serving size limit (HTTP 413)."""


def _make_handler(service: InferenceService):
    class Handler(BaseHTTPRequestHandler):
        # quiet: one access-log line per request at most
        def log_message(self, fmt, *args):  # noqa: D102
            pass

        def _json(self, code: int, payload: Dict):
            body = json.dumps(payload).encode("utf-8")
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._json(200, {
                    "status": "ok",
                    "max_seq": service.max_seq,
                    "batch_buckets": list(service.predictor.batch_buckets),
                })
            elif self.path.split("?")[0] == "/metrics":
                snap = service.stats.snapshot()
                accept = self.headers.get("Accept", "")
                if ("format=prometheus" in self.path
                        or "openmetrics" in accept
                        or accept.startswith("text/plain")):
                    body = prometheus_text(snap).encode("utf-8")
                    self.send_response(200)
                    self.send_header("Content-Type",
                                     "text/plain; version=0.0.4")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                else:
                    self._json(200, snap)
            else:
                self._json(404, {"error": f"unknown path {self.path}"})

        def _read_body(self) -> bytes:
            """Read the request body, enforcing MAX_BODY_BYTES BEFORE the
            read so an oversized Content-Length never allocates."""
            length = int(self.headers.get("Content-Length", 0))
            if length < 0:
                # rfile.read(-1) would buffer until EOF — unbounded
                raise ValueError(f"bad Content-Length {length}")
            if length > MAX_BODY_BYTES:
                raise PayloadTooLarge(
                    f"request body {length} bytes > {MAX_BODY_BYTES} limit")
            return self.rfile.read(length)

        def do_POST(self):
            if self.path == "/reload":
                try:
                    req = json.loads(self._read_body() or b"{}")
                    load_path = req.get("load_path")
                    if not isinstance(load_path, str) or not load_path:
                        self._json(400, {"error":
                                         "'load_path' (string) is required"})
                        return
                except PayloadTooLarge as e:
                    self._json(413, {"error": str(e)[:400]})
                    return
                except Exception as e:  # noqa: BLE001 — malformed request
                    self._json(400, {"error": f"bad request: {repr(e)[:400]}"})
                    return
                try:
                    service.reload(load_path)
                    self._json(200, {"status": "reloaded",
                                     "load_path": load_path})
                except BlockingIOError as e:
                    self._json(409, {"error": str(e)})
                except (ValueError, FileNotFoundError) as e:
                    self._json(400, {"error": repr(e)[:500]})
                except Exception as e:  # noqa: BLE001 — keep serving
                    self._json(500, {"error": repr(e)[:500]})
                return
            if self.path not in ("/predict", "/predict_batch"):
                self._json(404, {"error": f"unknown path {self.path}"})
                return

            def parse_item(req):
                """-> (text, image_bytes). Raises ValueError on bad input."""
                if not isinstance(req, dict):
                    raise ValueError("each item must be a JSON object")
                text = req.get("text")
                if not isinstance(text, str):
                    raise ValueError("'text' (string) is required")
                image_bytes = None
                if req.get("image_b64"):
                    # tolerate MIME/PEM-style whitespace wrapping (newlines
                    # every 76 chars) while still rejecting garbage
                    b64 = "".join(req["image_b64"].split())
                    if len(b64) > MAX_IMAGE_BYTES * 4 // 3 + 4:
                        raise PayloadTooLarge(
                            f"image_b64 decodes to > {MAX_IMAGE_BYTES} "
                            f"bytes")
                    image_bytes = base64.b64decode(b64, validate=True)
                return text, image_bytes

            # Client errors (bad JSON, bad base64, wrong types) -> 400 so
            # retry policies / load balancers don't re-send the unfixable;
            # size-limit violations -> 413.
            try:
                req = json.loads(self._read_body() or b"{}")
                if self.path == "/predict_batch":
                    items = req.get("items") if isinstance(req, dict) else None
                    if not isinstance(items, list) or not items:
                        raise ValueError(
                            "'items' (non-empty list of predict bodies) "
                            "is required")
                    if len(items) > 512:
                        raise ValueError(
                            f"too many items ({len(items)} > 512); chunk "
                            f"the request")
                    requests = [parse_item(it) for it in items]
                else:
                    requests = None
                    text, image_bytes = parse_item(req)
            except PayloadTooLarge as e:
                self._json(413, {"error": str(e)[:400]})
                return
            except Exception as e:  # noqa: BLE001 — malformed request
                self._json(400, {"error": f"bad request: {repr(e)[:400]}"})
                return
            try:
                if requests is not None:
                    self._json(200,
                               {"results": service.predict_many(requests)})
                else:
                    self._json(200, service.predict_one(text, image_bytes))
            except Exception as e:  # noqa: BLE001 — serving must not die
                self._json(500, {"error": repr(e)[:500]})

    return Handler


class _HTTPServer(ThreadingHTTPServer):
    # the listen backlog: socketserver's default of 5 leaves the sixth
    # client that connects at once waiting for a SYN retransmit (1 s)
    request_queue_size = 128


def make_server(service: InferenceService, host: str = "127.0.0.1",
                port: int = 8000) -> ThreadingHTTPServer:
    """Bind (port 0 = ephemeral); call .serve_forever() / .shutdown()."""
    return _HTTPServer((host, port), _make_handler(service))


# ----------------------------------------------------------------------
_SERVE_DEFAULTS = dict(bert_name="bert-base-uncased",
                       vit_name="openai/clip-vit-base-patch32",
                       max_seq=64, DR_step=4, num_classes=3,
                       compute_dtype="bfloat16")


def resolve_serve_config(load_path: str, config_json: Optional[str] = None,
                         **overrides):
    """Build the serving D2RConfig for a checkpoint.

    Geometry resolution, highest priority first: explicitly-passed CLI
    overrides (non-None kwargs) > the checkpoint's training-time
    ``config.json`` (looked for inside ``load_path``, then one directory up,
    where the trainer writes it beside ``best_model``) > the serving
    defaults. The result must be one the port supports
    (``D2RConfig.check_supported``)."""
    from d2r_tpu_torch.config import D2RConfig, load_config_json

    if config_json is not None:
        if not os.path.exists(config_json):
            raise FileNotFoundError(f"--config_json {config_json} not found")
        candidates = [config_json]
    else:
        root = os.path.abspath(load_path).rstrip("/")
        candidates = [os.path.join(root, "config.json"),
                      os.path.join(os.path.dirname(root), "config.json")]
    loaded = None
    for cand in candidates:
        if os.path.exists(cand):
            loaded = load_config_json(cand)
            print(f"model geometry from {cand}", flush=True)
            break

    base = loaded if loaded is not None else D2RConfig()
    if base.quant_train != "none":
        # a training-time knob; serving quantization is --quantize, which
        # quantizes the restored fp32 weights once
        print(f"ignoring training-time quant_train={base.quant_train!r} "
              "for serving (use --quantize for int8 serving)", flush=True)
        base = dataclasses.replace(base, quant_train="none")
    fields = {}
    for name, default in _SERVE_DEFAULTS.items():
        if overrides.get(name) is not None:
            fields[name] = overrides[name]
        elif loaded is None:
            fields[name] = default
    unknown = set(overrides) - set(_SERVE_DEFAULTS)
    if unknown:  # a raise, not an assert: must survive `python -O`
        raise ValueError(f"unexpected serve overrides: {sorted(unknown)}")
    cfg = dataclasses.replace(base, **fields)
    cfg.check_supported()   # one process serves
    return cfg


def build_arg_parser():
    import argparse

    ap = argparse.ArgumentParser(description=main.__doc__)
    ap.add_argument("--load_path", required=True,
                    help="checkpoint dir (e.g. .../best_model, holding model.pth)")
    ap.add_argument("--config_json", default=None,
                    help="config.json written at training time (default: "
                         "auto-discover inside/next to --load_path). Flags "
                         "below override individual fields; without any "
                         "config.json the remaining geometry is the serving "
                         "default")
    ap.add_argument("--bert_name", default=None)
    ap.add_argument("--vit_name", default=None)
    ap.add_argument("--vocab_file", default=None,
                    help="local tokenizer assets: vocab.txt path/dir "
                         "(WordPiece) or a dir with vocab.json+merges.txt "
                         "(byte-level BPE, RoBERTa towers); overrides "
                         "--bert_name for tokenizer resolution")
    ap.add_argument("--max_seq", type=int, default=None)
    ap.add_argument("--DR_step", type=int, default=None)
    ap.add_argument("--num_classes", type=int, default=None)
    ap.add_argument("--batch_buckets", default="1,8,32")
    ap.add_argument("--max_wait_ms", type=float, default=5.0)
    ap.add_argument("--probe_ms", type=float, default=None,
                    help="MicroBatcher adaptive first-request probe window "
                         "(default max_wait_ms/10, >=1 ms); --probe_ms == "
                         "--max_wait_ms gives a fixed coalescing window")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--dp", type=int, default=1,
                    help="shard request batches over this many processes, one a "
                         "card (data axis); 1 = one process")
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor-parallel degree for the tower weights (model "
                         "axis); composes with --dp on dp*tp processes")
    ap.add_argument("--compute_dtype", default=None)
    ap.add_argument("--fallback_image", default=None)
    ap.add_argument("--quantize", default=None, choices=["int8"],
                    help="weight-only int8 serving (d2r_tpu_torch/quant.py)")
    ap.add_argument("--no_warmup", action="store_true")
    return ap


def build_service(args):
    """Everything ``main`` does but serve: resolve the config, build and
    warm the predictor (one CUDA graph per batch bucket on the card), wrap
    it in an ``InferenceService`` whose ``/reload`` reruns the same build,
    and bind the HTTP server. Returns ``(service, httpd)``; the caller runs
    ``httpd.serve_forever()`` and, at the end, ``httpd.shutdown()``,
    ``httpd.server_close()`` and ``service.close()``. With ``--dp``/``--tp``
    it starts the follower processes and joins them as rank 0 first; the
    service's ``close`` ends them."""
    mesh = channel = None
    if args.dp * args.tp > 1:
        mesh, channel = _start_mesh(args)
    try:
        predictor, tokenizer, build_predictor = _predictor_pipeline(args, mesh)
        factory = build_predictor
        if channel is not None:
            predictor = _Broadcasting(predictor, channel)
            factory = lambda path: _Broadcasting(channel.reload(path, build_predictor), channel)
        service = InferenceService(predictor, tokenizer,
                                   fallback_image=args.fallback_image,
                                   max_wait_ms=args.max_wait_ms,
                                   probe_ms=args.probe_ms,
                                   predictor_factory=factory)
    except BaseException:
        if channel is not None:
            channel.close()
        raise
    service.channel = channel
    try:
        httpd = make_server(service, args.host, args.port)
    except OSError:
        service.close()
        raise
    return service, httpd


def _predictor_pipeline(args, mesh=None, rank=0):
    """(the first predictor, the tokenizer, the build function): the
    config resolved, the predictor restored, quantized, placed on ``mesh``
    and warmed; the build function is also the POST /reload factory. Every
    rank of a mesh runs it alike."""
    import numpy as np

    from d2r_tpu_torch.config import resolve_device
    from d2r_tpu_torch.data.tokenizer import load_tokenizer
    from d2r_tpu_torch.serve import Predictor
    from d2r_tpu_torch.train.checkpoint import check_checkpoint_geometry, restore_model

    device = resolve_device(args.device) if mesh is None else mesh.device
    cfg = resolve_serve_config(
        args.load_path, config_json=args.config_json,
        bert_name=args.bert_name, vit_name=args.vit_name,
        max_seq=args.max_seq, DR_step=args.DR_step,
        num_classes=args.num_classes, compute_dtype=args.compute_dtype)
    tokenizer = load_tokenizer(args.vocab_file or cfg.bert_name,
                               vocab_size=cfg.text_config().vocab_size)
    buckets = tuple(int(b) for b in args.batch_buckets.split(","))

    def build_predictor(load_path: str):
        """Shared restore -> quantize -> warmup pipeline; also the POST
        /reload factory (same geometry enforced via the checkpoint's
        config.json)."""
        check_checkpoint_geometry(load_path, cfg)
        pred = Predictor(cfg, restore_model(load_path, cfg, device),
                         batch_buckets=buckets, device=device, quantize=args.quantize,
                         mesh=mesh)
        if not args.no_warmup:
            if rank == 0:
                print("warming up every batch bucket (a CUDA graph each on the card, "
                      "eager over a model axis)...", flush=True)
            pred.warmup(pixel_dtype=np.uint8)
        return pred

    return build_predictor(args.load_path), tokenizer, build_predictor


# ---- serving over a mesh ---------------------------------------------------

# the environment variable that makes ``python -m d2r_tpu_torch.server`` a
# follower rank: JSON {"rank", "world", "port", "args"}
FOLLOWER_ENV = "D2R_SERVE_FOLLOWER"
# the longest rank 0 waits in a collective of the mesh
SERVE_TIMEOUT = datetime.timedelta(seconds=120)
# a follower waits for rank 0's next broadcast without limit (an idle
# service sends nothing); rank 0's end closes the connection
_IDLE = datetime.timedelta(days=365)
_PREDICT, _RELOAD, _STOP = 1, 2, 3
_PIXELS = (np.uint8, np.float32)


def _join(args, rank: int, world: int, port: int):
    """Join the serving mesh as ``rank``: the process group (NCCL where
    every rank has a card of its own, else gloo), the (data, model) mesh,
    and the gloo group of the broadcasts. Returns (mesh, control group)."""
    import torch
    import torch.distributed as dist

    from d2r_tpu_torch.config import resolve_device
    from d2r_tpu_torch.parallel import distributed
    from d2r_tpu_torch.parallel.mesh import make_mesh

    device = resolve_device(args.device)
    if device.type == "cuda":
        device = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
    own_cards = device.type == "cuda" and torch.cuda.device_count() >= world
    timeout = SERVE_TIMEOUT if rank == 0 else _IDLE
    distributed.initialize(f"127.0.0.1:{port}", world, rank, device=device,
                           backend=distributed.default_backend(device) if own_cards
                           else "gloo", timeout=timeout)
    shape, axes = (((args.dp, args.tp), ("data", "model")) if args.tp > 1
                   else ((args.dp,), ("data",)))
    mesh = make_mesh(shape, axes, device, timeout=SERVE_TIMEOUT)
    return mesh, dist.new_group(backend="gloo", timeout=timeout)


def _start_mesh(args):
    """Start the ``dp x tp - 1`` followers and join them as rank 0.
    Returns (mesh, channel)."""
    from d2r_tpu_torch.parallel.launch import free_port, rank_env
    world, port = args.dp * args.tp, free_port()
    procs = []
    for rank in range(1, world):
        env = rank_env(rank, world, port)
        env[FOLLOWER_ENV] = json.dumps({"rank": rank, "world": world, "port": port,
                                        "args": vars(args)})
        procs.append(subprocess.Popen([sys.executable, "-m", "d2r_tpu_torch.server"],
                                      env=env))
    try:
        mesh, group = _join(args, 0, world, port)
    except BaseException:
        for p in procs:
            p.kill()
        raise
    print(f"serving over mesh {mesh.shape}: rank 0 and followers "
          f"{[p.pid for p in procs]}", flush=True)
    return mesh, MeshChannel(group, procs)


def _bcast(t, group):
    import torch.distributed as dist
    dist.broadcast(t, 0, group=group)
    return t


class MeshChannel:
    """Rank 0's broadcasts to the followers, over a gloo group. Each
    message is a header (op, rows, pixel dtype) and its payload; one lock
    keeps a message and the forward or rebuild that follows it together,
    so every rank runs its collectives in one order."""

    def __init__(self, group, procs):
        self.group, self.procs = group, procs
        self._lock = threading.Lock()
        self.closed = False

    def _header(self, op: int, n: int = 0, pixel: int = 0) -> None:
        import torch
        _bcast(torch.tensor([op, n, pixel], dtype=torch.int64), self.group)

    def predict(self, predictor, arrays: Sequence[np.ndarray]):
        import torch
        with self._lock:
            self._header(_PREDICT, arrays[0].shape[0], _PIXELS.index(arrays[3].dtype.type))
            for x in arrays:
                _bcast(torch.from_numpy(np.ascontiguousarray(x)), self.group)
            return predictor.predict(*arrays)

    def reload(self, load_path: str, build: Callable):
        import torch
        with self._lock:
            path = np.frombuffer(load_path.encode(), np.uint8).copy()
            self._header(_RELOAD, path.size)
            _bcast(torch.from_numpy(path), self.group)
            return build(load_path)

    def close(self) -> None:
        """End the followers' loop and the process group; wait for the
        followers to exit."""
        import torch.distributed as dist
        if self.closed:
            return
        self.closed = True
        try:
            with self._lock:
                self._header(_STOP)
        finally:
            dist.destroy_process_group()
            for p in self.procs:
                try:
                    p.wait(timeout=60)
                except subprocess.TimeoutExpired:
                    p.kill()
                    p.wait()


class _Broadcasting:
    """Rank 0's predictor over a mesh: ``predict`` goes through the
    channel, which broadcasts the request first; the rest is the
    predictor's."""

    def __init__(self, predictor, channel: MeshChannel):
        self._predictor, self._channel = predictor, channel

    def __getattr__(self, name):
        return getattr(self._predictor, name)

    def predict(self, *arrays):
        return self._channel.predict(self._predictor, arrays)


def follow(args, rank: int, world: int, port: int) -> None:
    """A follower rank: join the mesh, build the predictor, then run what
    rank 0 broadcasts (a forward, a rebuild) until it says stop."""
    import torch
    import torch.distributed as dist

    mesh, group = _join(args, rank, world, port)
    try:
        predictor, _, build_predictor = _predictor_pipeline(args, mesh, rank)
        seq = predictor.seq_len
        vc = predictor.cfg.vision_config()
        while True:
            op, n, pixel = _bcast(torch.zeros(3, dtype=torch.int64), group).tolist()
            if op == _STOP:
                return
            if op == _RELOAD:
                path = _bcast(torch.zeros(n, dtype=torch.uint8), group).numpy()
                predictor = build_predictor(path.tobytes().decode())
                continue
            shapes = [(n, seq)] * 3 + [(n, vc.num_channels, vc.image_size, vc.image_size)]
            dtypes = [np.int32] * 3 + [_PIXELS[pixel]]
            arrays = [_bcast(torch.from_numpy(np.zeros(s, dt)), group).numpy()
                      for s, dt in zip(shapes, dtypes)]
            predictor.predict(*arrays)
    finally:
        dist.destroy_process_group()


def main(argv=None):
    """`python -m d2r_tpu_torch.server`: load a trained checkpoint and serve
    HTTP predictions."""
    if os.environ.get(FOLLOWER_ENV):
        spec = json.loads(os.environ[FOLLOWER_ENV])
        follow(argparse.Namespace(**spec["args"]), spec["rank"], spec["world"], spec["port"])
        return
    args = build_arg_parser().parse_args(argv)
    service, httpd = build_service(args)
    predictor = service.predictor
    print(f"serving on http://{args.host}:{httpd.server_address[1]} "
          f"(buckets {predictor.batch_buckets}, seq {predictor.seq_len}, "
          f"device {predictor.device})", flush=True)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()
        service.close()


if __name__ == "__main__":
    main()
