"""Serving path (counterpart of ``d2r_tpu/serve.py``): a bucketed batch
predictor over a ``D2RClassifier``, and ``latency_stats``.

Requests are padded up to the nearest batch bucket and to the one sequence
length, run, and the padding rows stripped. There is exactly one sequence
bucket: the Router mean-pools over padded tokens, so the same request padded
to two lengths would give two answers. Rows are independent (BatchNorm runs
on its running statistics), so batch padding changes nothing.

On a CUDA device each (batch bucket, pixel dtype) runs as one CUDA graph,
the port's counterpart of the JAX package's one jitted program per bucket
(JAX retraces per input dtype, so the dtype is part of the key). Its first
request or ``warmup`` runs the eager forward once on static input buffers
(building the kernels and warming cuBLAS), then captures it into a graph
pool that all buckets of the predictor share. Every request after that
copies its padded rows into the static buffers through pinned host buffers,
replays the graph on the caller's stream and copies the probabilities out,
so it allocates nothing on the device. A capture fails loudly; nothing falls
back to the eager path on the card. On the CPU ``predict`` runs the eager
forward.

The bucket forward is ``Predictor._program(b)``: here the model's eager
forward; ``export.ExportedPredictor`` supplies the bucket's exported program
instead and inherits the rest (buckets, padding, chunking, staging, graphs,
``latency_stats``).

Captures use ``capture_error_mode="thread_local"``: a server builds and
warms a new predictor on one thread while another thread keeps replaying
the old one (``server.InferenceService.reload``).

**Over a mesh** (``mesh``, a (data, model) ``parallel.mesh.Mesh`` of one
process per card; the counterpart of the JAX predictor's ``mesh``): every
rank of the mesh builds the predictor from the whole model and calls
``predict``, ``warmup`` and ``latency_stats`` together, with the same
requests. The model takes its training placements (``shard_model``, after
``unpipelined`` and ``quantize_model``; the int8 codes and scales follow
the dense weight's split): the tensor-parallel rules on the model axis,
whole weights on every data rank. A bucket's rows are split over the data
axis where the bucket divides it, and every data rank runs the whole
bucket otherwise, as the JAX predictor's ``_place`` shards or replicates;
the probabilities are gathered over the data group in rank order (a
zero-padded sum, ``parallel.distributed``), so every rank returns the same
answer. Rows are independent, so the model itself sees no data group. With
no model axis a rank's forward has no collective, and on the card each
rank replays its own CUDA graph of its rows, the gather running outside
it; with one, the forward runs eagerly (the model group's collectives run
over gloo, which a graph cannot capture; a step under NCCL waits for two
cards, as training's capture does).
"""

from __future__ import annotations

import bisect
import contextlib
import functools
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from d2r_tpu_torch.config import D2RConfig, resolve_device, serving_config
from d2r_tpu_torch.models.layers import Embed, QKVDense, TorchLinear
from d2r_tpu_torch.models.unimo import unpipelined
from d2r_tpu_torch.models.vit import PatchConv
from d2r_tpu_torch.parallel import distributed
from d2r_tpu_torch.parallel.mesh import Mesh, shard_model
from d2r_tpu_torch.quant import Int8Weight, quantize_model


@torch.no_grad()
def compute_cast(model: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Cast the matrix weights to the compute type once, in place, as
    ``d2r_tpu/train/state.py::_compute_cast`` selects them: the ``kernel`` and
    ``embedding`` leaves (Linear, QKV, conv and embedding weights). Biases,
    LayerNorm, BatchNorm and the other parameters stay fp32 and are cast at
    use. Int8 weights stay int8: they are dequantized to the compute type at
    use."""
    if dtype == torch.float32:
        return model
    for m in model.modules():
        if (isinstance(m, (TorchLinear, QKVDense, Embed, PatchConv))
                and not isinstance(m, Int8Weight)):
            m.weight.data = m.weight.data.to(dtype)
    return model


def pad_into(buf: np.ndarray, x: np.ndarray) -> None:
    """Write ``x`` into the leading rows (and, for 2-D inputs, the leading
    columns) of ``buf`` and zero the rest: ``np.pad`` with zeros, in
    place."""
    if x.ndim != buf.ndim or any(d > s for d, s in zip(x.shape, buf.shape)) or (
            x.ndim > 2 and x.shape[1:] != buf.shape[1:]):
        raise ValueError(f"an input of shape {x.shape} does not fit the bucket's {buf.shape}")
    n = x.shape[0]
    if x.shape[1:] != buf.shape[1:]:
        buf[:n] = 0
    buf[n:] = 0
    buf[(slice(0, n),) + tuple(slice(0, d) for d in x.shape[1:])] = x


def bucket_probs(model: nn.Module, input_ids, attention_mask, token_type_ids, pixel_values,
                 tensors: Optional[Dict[str, torch.Tensor]] = None) -> torch.Tensor:
    """fp32 probabilities of ``model``'s eval forward on one bucket's device
    tensors; with ``tensors``, the model's parameters and buffers replaced
    by them (``torch.func.functional_call``), as an exported bucket program
    takes them."""
    labels = torch.zeros(input_ids.shape[0], dtype=torch.long, device=input_ids.device)
    args = (input_ids, attention_mask, token_type_ids, labels, pixel_values)
    _, logits, _ = (model(*args) if tensors is None
                    else torch.func.functional_call(model, tensors, args))
    return torch.softmax(logits.float(), dim=-1)


class _BucketGraph:
    """One captured bucket forward: pinned host staging buffers, the static
    device inputs they are copied into, the graph, its probabilities on the
    device and their pinned host copy."""

    def __init__(self, host: List[torch.Tensor], inputs: List[torch.Tensor],
                 graph: "torch.cuda.CUDAGraph", probs: torch.Tensor):
        self.host = host
        self.inputs = inputs
        self.graph = graph
        self.probs = probs
        self.probs_host = torch.empty(probs.shape, dtype=probs.dtype, pin_memory=True)


class Predictor:
    """Bucketed batch predictor. Takes ownership of ``model``: it is moved to
    ``device``, its matrix weights quantized when ``quantize="int8"``
    (``quant.quantize_model``), cut to this rank's slices over ``mesh``
    (see the module docstring), and the others cast to the config's compute
    type."""

    def __init__(self, cfg: D2RConfig, model: nn.Module,
                 batch_buckets: Sequence[int] = (1, 8, 32),
                 seq_buckets: Optional[Sequence[int]] = None,
                 device="cuda", quantize: Optional[str] = None,
                 mesh: Optional[Mesh] = None):
        self.device = resolve_device(device)
        # a pipelined model serves unpipelined, as the JAX package's does
        # (d2r_tpu/serve.py:41-55): a bucket of 1 divides no microbatches
        self.cfg = cfg = serving_config(cfg)
        model = unpipelined(model).eval()
        if quantize:
            quantize_model(model, quantize)
        self.mesh = mesh if mesh is not None and mesh.world > 1 else None
        if self.mesh is not None:
            if self.mesh.pp > 1:
                raise ValueError("serving runs unpipelined: a mesh of (data, model) axes, "
                                 f"not {self.mesh.shape}")
            model = shard_model(model, self.mesh.model_row())
        self.model = compute_cast(model.to(self.device), cfg.dtype)
        # CUDA graphs wherever the forward holds no collective
        self._graphs = self.device.type == "cuda" and (self.mesh is None or self.mesh.tp == 1)
        self.batch_buckets = sorted(batch_buckets)
        seq_buckets = sorted(seq_buckets or [cfg.max_seq])
        if len(seq_buckets) != 1:
            raise ValueError(
                f"multiple seq_buckets {seq_buckets} are unsafe: the router's "
                "pad-pooling makes logits depend on the padded sequence length, "
                "so bucket choice would change predictions. Use exactly one seq "
                "bucket (default: cfg.max_seq).")
        self.seq_len = seq_buckets[0]
        self.graphs: Dict[tuple, _BucketGraph] = {}
        self._pool = None
        self._stream = None
        # one request at a time owns the static buffers of the graphs
        self._lock = threading.Lock()

    def _bucket(self, n: int) -> int:
        i = bisect.bisect_left(self.batch_buckets, n)
        return self.batch_buckets[min(i, len(self.batch_buckets) - 1)]

    def tensors(self) -> Dict[str, torch.Tensor]:
        """The parameters and buffers the bucket forward reads, by name, as
        they lie on the device (quantized and cast): the first input of an
        exported bucket program (``d2r_tpu_torch/export.py``)."""
        return {**dict(self.model.named_parameters()), **dict(self.model.named_buffers())}

    def _program(self, b: int) -> Callable:
        """The forward of batch bucket ``b``: (input_ids, attention_mask,
        token_type_ids, pixel_values) on the device -> fp32 probabilities.
        Here the model's own eager forward; ``export.ExportedPredictor``
        runs the bucket's exported program instead."""
        return functools.partial(bucket_probs, self.model)

    @torch.inference_mode()
    def _forward(self, input_ids, attention_mask, token_type_ids, pixel_values):
        """One bucket-sized forward on device tensors -> fp32
        probabilities."""
        return self._program(input_ids.shape[0])(input_ids, attention_mask, token_type_ids,
                                                 pixel_values)

    def _static_shapes(self, b: int):
        vc = self.cfg.vision_config()
        l = self.seq_len
        return [(b, l)] * 3 + [(b, vc.num_channels, vc.image_size, vc.image_size)]

    def graph(self, b: int, pixel_dtype=np.uint8) -> _BucketGraph:
        """The captured forward of batch bucket ``b`` for pixels of
        ``pixel_dtype``, captured at first use."""
        key = (b, np.dtype(pixel_dtype))
        if key not in self.graphs:
            self.graphs[key] = self._capture(b, key[1])
        return self.graphs[key]

    def _capture(self, b: int, pixel_dtype: np.dtype) -> _BucketGraph:
        if self.device.type != "cuda":
            raise RuntimeError(f"CUDA graphs need a CUDA device, not {self.device}")
        dtypes = [torch.int32] * 3 + [torch.from_numpy(np.zeros(0, pixel_dtype)).dtype]
        host = [torch.zeros(s, dtype=dt).pin_memory()
                for s, dt in zip(self._static_shapes(b), dtypes)]
        host[1].fill_(1)   # a full attention mask for the warm-up run
        with torch.cuda.device(self.device):
            if self._stream is None:
                self._stream = torch.cuda.Stream()
                self._pool = torch.cuda.graph_pool_handle()
            inputs = [h.to(self.device) for h in host]
            stream = self._stream
            stream.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(stream):
                self._forward(*inputs)           # builds the kernels, warms cuBLAS
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, pool=self._pool, stream=stream,
                                  capture_error_mode="thread_local"):
                probs = self._forward(*inputs)
            torch.cuda.current_stream().wait_stream(stream)
        return _BucketGraph(host, inputs, graph, probs)

    def _stage(self, g: _BucketGraph, arrays: Sequence[np.ndarray]) -> None:
        """Write ``arrays`` into the pinned buffers of ``g`` and queue their
        copies into its static inputs on the current stream."""
        for host, x in zip(g.host, arrays):
            pad_into(host.numpy(), x)
        with torch.cuda.device(self.device):
            for dst, src in zip(g.inputs, g.host):
                dst.copy_(src, non_blocking=True)

    def _replay(self, g: _BucketGraph, n: int) -> np.ndarray:
        """Replay ``g`` on the current stream and return the first ``n`` rows
        of its probabilities."""
        with torch.cuda.device(self.device):
            g.graph.replay()
            g.probs_host.copy_(g.probs, non_blocking=True)
            torch.cuda.current_stream().synchronize()
        return g.probs_host.numpy()[:n].copy()

    def _rows(self, b: int):
        """(rows this rank runs, the first one's index) of a bucket of
        ``b`` rows: its share where the data axis divides ``b``, else all."""
        dp = 1 if self.mesh is None else self.mesh.dp
        if dp > 1 and b % dp == 0:
            return b // dp, self.mesh.data_index * (b // dp)
        return b, 0

    @contextlib.contextmanager
    def staged(self, arrays: Sequence[np.ndarray], b: int):
        """Hold the predictor, stage this rank's rows of ``arrays`` (at
        most ``b`` rows) as a bucket of ``b`` on the device once, and yield
        a function that runs the bucket's forward on them (a graph replay,
        or the eager forward) and returns the bucket's (b, classes) fp32
        probabilities, gathered over the data group."""
        k, r0 = self._rows(b)
        local = [x[r0:r0 + k] for x in arrays]
        with self._lock:
            if self._graphs:
                g = self.graph(k, local[3].dtype)
                self._stage(g, local)
                run = lambda: self._replay(g, k)
            else:
                args = self._padded(local, k)
                run = lambda: self._forward(*args).cpu().numpy()
            yield run if k == b else (lambda: self._gather(run()))

    def _gather(self, probs: np.ndarray) -> np.ndarray:
        """The data ranks' rows of a bucket joined in rank order, on every
        rank."""
        t = torch.from_numpy(probs).to(self.mesh.collective_device)
        return distributed._gather(t, self.mesh.data_group, 0).cpu().numpy()

    def predict(self, input_ids: np.ndarray, attention_mask: np.ndarray,
                token_type_ids: np.ndarray, pixel_values: np.ndarray
                ) -> Dict[str, np.ndarray]:
        """Pad to the nearest bucket, run, strip padding. Requests above the
        largest bucket are chunked; sequences longer than the bucket raise
        (truncating would change predictions silently). Over a mesh every
        rank calls it with the same request and gets the whole answer."""
        n, l = input_ids.shape
        if l > self.seq_len:
            raise ValueError(
                f"sequence length {l} exceeds the configured seq bucket "
                f"{self.seq_len}; tokenize/truncate to max_seq before calling predict")
        max_b = self.batch_buckets[-1]
        if n > max_b:
            outs = [self.predict(input_ids[i:i + max_b], attention_mask[i:i + max_b],
                                 token_type_ids[i:i + max_b], pixel_values[i:i + max_b])
                    for i in range(0, n, max_b)]
            return {k: np.concatenate([o[k] for o in outs]) for k in outs[0]}
        arrays = (input_ids, attention_mask, token_type_ids, pixel_values)
        with self.staged(arrays, self._bucket(n)) as run:
            probs = run()[:n]
        return {"label": probs.argmax(-1), "probs": probs}

    def _padded(self, arrays: Sequence[np.ndarray], b: int) -> List[torch.Tensor]:
        """``arrays`` zero-padded to ``b`` rows and the sequence length, as
        tensors on the device."""
        out = []
        for x, shape in zip(arrays, self._static_shapes(b)):
            widths = [(0, s - d) for s, d in zip(shape, x.shape)]
            out.append(torch.from_numpy(np.ascontiguousarray(np.pad(x, widths))
                                        ).to(self.device))
        return out

    def warmup(self, pixel_dtype=np.uint8) -> None:
        """Prepare every bucket before serving: where it replays a CUDA
        graph, capture it for pixels of ``pixel_dtype`` (the dtype requests
        will carry); elsewhere (the CPU, a model axis), run it once. Over a
        mesh every rank calls it together."""
        for b in self.batch_buckets:
            if self._graphs:
                with self._lock:
                    self.graph(self._rows(b)[0], pixel_dtype)
            else:
                vc = self.cfg.vision_config()
                l = self.seq_len
                self.predict(np.zeros((b, l), np.int32), np.ones((b, l), np.int32),
                             np.zeros((b, l), np.int32),
                             np.zeros((b, vc.num_channels, vc.image_size, vc.image_size),
                                      pixel_dtype))


def _times(run, iters: int, warmup: int) -> List[float]:
    out = []
    for i in range(warmup + iters):
        t0 = time.perf_counter()
        run()
        if i >= warmup:
            out.append(time.perf_counter() - t0)
    return out


def latency_stats(predictor: Predictor, batch: Dict[str, np.ndarray],
                  iters: int = 20, warmup: int = 3,
                  device_resident: bool = False) -> Dict[str, float]:
    """Steady-state request latency (seconds): mean / p50 / p95.

    ``device_resident=True`` stages the padded inputs on the device once and
    times only the forward (on a CUDA device, the graph's replay where it
    has one) plus the download of the probabilities (and, over a mesh, their
    gather): the model-side latency. The default times the whole
    ``predict``, padding and host-to-device copies included. Over a mesh
    every rank calls it together."""
    arrays = [batch[k] for k in ("input_ids", "attention_mask", "token_type_ids",
                                 "pixel_values")]
    n = arrays[0].shape[0]
    if not device_resident:
        times = _times(lambda: predictor.predict(*arrays), iters, warmup)
    elif n > predictor.batch_buckets[-1]:
        raise ValueError(f"device_resident timing takes one bucket; got {n} rows")
    else:
        with predictor.staged(arrays, predictor._bucket(n)) as run:
            times = _times(run, iters, warmup)
    xs = sorted(times)
    return {
        "mean": sum(xs) / len(xs),
        "p50": xs[len(xs) // 2],
        "p95": xs[min(int(len(xs) * 0.95), len(xs) - 1)],
    }
