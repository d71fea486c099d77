"""Continuous-batching inference server — counterpart of
``feathercnn_tpu/serve/server.py`` over the port's ``Engine``.

Across processes (``parallel.maybe_initialize_distributed``) every
process enters each batch with rank 0's plan (``broadcast_plan``); in one
process that is the identity.  The queue is the C++ one (``native.NativeBatchQueue``), or
the Python one with ``prefer_native_queue=False``.  With ``pipeline_depth`` > 1
batch k+1 is dispatched before batch k is fetched: PyTorch's CUDA calls
return before the card finishes, so the next batch's host->device copy and
kernels are queued while the previous result is copied back.

Per-process ingest queues feed fixed-shape batch slots: a collector
thread pads each collected batch to the smallest slot that fits, runs the
engine, and scatters results back to callers.  The worker catches
per-batch failures, re-runs the batch up to ``max_retries`` times, and
marks the server unhealthy after repeated faults; a heartbeat thread
exposes liveness and queue-depth gauges.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..engine import Engine
from .batcher import make_queue

__all__ = ["InferenceServer", "InferenceFailed"]


class InferenceFailed(RuntimeError):
    """The serve loop exhausted its retries for this request's batch."""


def broadcast_plan(n_real: int) -> int:
    """Agree on the batch plan across processes: rank 0's ``n_real`` on
    every rank when the process group has more than one; else the
    identity."""
    import torch.distributed as dist
    if dist.is_initialized() and dist.get_world_size() > 1:
        from ..parallel.dist import broadcast
        return int(broadcast(torch.tensor([n_real], dtype=torch.int32))[0])
    return n_real


class InferenceServer:
    def __init__(self, engine: Engine, batch_size: int = 32,
                 batch_timeout_us: int = 2000, max_retries: int = 1,
                 prefer_native_queue: bool = True,
                 transfer_dtype: Optional[str] = "auto",
                 batch_slots: Optional[list] = None,
                 extra_inputs: Optional[Dict[str, np.ndarray]] = None,
                 pipeline_depth: int = 2):
        """``extra_inputs``: fixed per-deployment values for graph
        inputs beyond the first (e.g. the two-stage detectors'
        ``im_info`` — one image geometry per serving endpoint).

        ``pipeline_depth`` > 1 double-buffers the serve loop: batch k's
        device fetch is deferred until batch k+1 has been DISPATCHED, so
        the next host->device transfer and compute overlap the previous
        fetch (CUDA launches are asynchronous; the copy to the host is
        the sync point).
        1 restores the fully synchronous loop."""
        self.engine = engine
        self.batch_size = batch_size
        self.batch_timeout_us = batch_timeout_us
        self.max_retries = max_retries
        self.pipeline_depth = pipeline_depth
        # Multiple batch slots: a lightly loaded server runs small batches
        # at low latency instead of padding every request group up to the
        # full slot.  Slots are sorted ascending; dispatch picks the
        # smallest slot that fits the collected group.
        self.batch_slots = sorted(set((batch_slots or []) + [batch_size]))
        # Reduced-precision host->device transfer shrinks the bytes on
        # the wire.  "auto": a full-int8 engine quantizes host-side with
        # the first conv's calibrated input scale (4x less than f32 — the
        # in-graph path accepts int8 directly); else bf16 when the
        # compute dtype allows; "bfloat16"/"int8"/None force a mode.
        self._transfer_dtype = None
        self._transfer_scale = None
        if transfer_dtype in ("auto", "int8") \
                and engine.config.quant == "w8a8":
            qm = engine.graph.meta.get("quant", {})
            graph_in = next(iter(engine.graph.inputs))
            # the scale only applies if the first conv consumes the raw
            # graph input directly (no mean-subtract/Scale/pool between)
            first_conv = next((n for n in engine.graph.nodes
                               if n.op == "Convolution"
                               and n.inputs[0] == graph_in), None)
            info = (qm.get(first_conv.name, {})
                    if first_conv is not None else {})
            # fp-act stems keep input_scale so int8 transfer still works
            # (the stem dequantizes in its epilogue-fused prologue)
            xs = info.get("x_scale") or info.get("input_scale")
            if xs:
                self._transfer_dtype = np.int8
                self._transfer_scale = float(xs)
        if (self._transfer_dtype is None and transfer_dtype
                and transfer_dtype != "int8"
                and engine.config.compute_dtype != "float32"):
            self._transfer_dtype = getattr(
                torch, "bfloat16" if transfer_dtype == "auto"
                else transfer_dtype)

        names = list(engine.graph.inputs)
        in_name = names[0]
        self._in_name = in_name
        self._extra_inputs = {}
        for nm in names[1:]:
            if extra_inputs is None or nm not in extra_inputs:
                raise ValueError(
                    f"engine has extra graph input {nm!r}: pass a fixed "
                    "value via InferenceServer(extra_inputs={...})")
            self._extra_inputs[nm] = np.asarray(extra_inputs[nm],
                                                np.float32)
        in_spec = engine.graph.inputs[in_name]
        self._item_shape = tuple(in_spec.shape[1:])
        self._out_names = list(engine.graph.outputs)
        out_shapes = [tuple(int(d) for d in engine.graph.specs[nm].shape)
                      for nm in self._out_names]
        # Detection graphs emit ROI-major outputs ((N*R, 5) rois,
        # (N*R, classes) scores) whose leading dim is NOT the image
        # batch.  Proposal emits rows IMAGE-MAJOR (R consecutive rows
        # per image, ops/lowering.py), so when every output's leading
        # dim is an integer multiple of the batch, each request gets
        # its contiguous row block; otherwise fall back to
        # whole-output-per-image at batch 1.
        nb = in_spec.shape[0]
        self._whole_output = any(s[0] != nb for s in out_shapes)
        if self._whole_output and all(s[0] % nb == 0
                                      for s in out_shapes):
            per_req = [(s[0] // nb,) + tuple(s[1:]) for s in out_shapes]
            self._whole_output = False
        elif self._whole_output:
            if nb != 1 or batch_size != 1:
                raise ValueError(
                    f"outputs {self._out_names} are not image-batch-major "
                    f"({out_shapes}); serve this engine at batch_size=1")
            self.batch_slots = [1]
            per_req = out_shapes
        else:
            per_req = [s[1:] for s in out_shapes]
        # Per-request result layout.  One output: its natural shape (the
        # round-1 contract).  Multiple outputs (two-stage detectors emit
        # cls_prob/bbox_pred/rois): the queue carries one flat row per
        # request — the concat of every output flattened — and
        # ``unpack_outputs`` restores the name->array dict.
        self._out_specs = list(zip(self._out_names, per_req))
        if len(self._out_names) == 1:
            self._result_shape = per_req[0]
        else:
            self._result_shape = (
                int(sum(int(np.prod(s)) for s in per_req)),)

        # Quantize-on-INGEST: when the engine takes int8 input, the
        # queue itself carries int8 items — each request quantizes once
        # on its own client thread (or arrives pre-quantized), so the
        # serve loop's batch assembly is a byte memcpy instead of a
        # whole-batch numpy round/clip/cast, and queue memory shrinks 4x.
        self._queue_dtype = (np.dtype(np.int8)
                             if self._transfer_scale is not None
                             else np.dtype(np.float32))
        self.queue = make_queue(self._item_shape, self._queue_dtype,
                                self._result_shape, np.float32,
                                prefer_native=prefer_native_queue)

        self._failed: Dict[int, bool] = {}
        self._failed_lock = threading.Lock()
        self._stop = threading.Event()
        self._healthy = threading.Event()
        self._healthy.set()
        self._fault_count = 0
        self._last_heartbeat = time.time()
        self.metrics: Dict[str, Any] = {
            "batches": 0, "images": 0, "pad_images": 0,
            "batch_latency_ms_sum": 0.0, "faults": 0,
        }
        self._worker: Optional[threading.Thread] = None
        self._heartbeat: Optional[threading.Thread] = None

    # ------------------------------------------------------------------
    def start(self) -> None:
        # Run every batch slot once up front, with the dtype _run_batch
        # will send, so the weights' upload and the kernels' build happen
        # before the first request.
        for slot in self.batch_slots:
            warm = np.zeros((slot,) + self._item_shape, np.float32)
            warm = self._to_transfer(warm)
            self.engine.run({self._in_name: warm, **self._extra_inputs})
        self._worker = threading.Thread(target=self._serve_loop, daemon=True)
        self._worker.start()
        self._heartbeat = threading.Thread(target=self._heartbeat_loop,
                                           daemon=True)
        self._heartbeat.start()

    def stop(self) -> None:
        self._stop.set()
        self.queue.close()
        if self._worker:
            self._worker.join(timeout=5)

    # ------------------------------------------------------------------
    def infer(self, image: np.ndarray, timeout_s: float = 30.0
              ) -> Optional[np.ndarray]:
        """Client call: submit one image, block for its result.

        Returns None on queue-closed/timeout; raises ``InferenceFailed``
        if the serve loop exhausted its retries on this request's batch.
        Multi-output engines return the packed flat row — use
        ``infer_outputs`` for the name->array dict."""
        if self._queue_dtype == np.int8 and image.dtype != np.int8:
            image = np.clip(
                np.round(image.astype(np.float32) / self._transfer_scale),
                -127, 127).astype(np.int8)
        ticket = self.queue.submit(image.astype(self._queue_dtype))
        if not ticket:
            return None
        out = self.queue.wait_result(ticket, int(timeout_s * 1e6))
        with self._failed_lock:
            failed = self._failed.pop(ticket, False)
        if failed:
            raise InferenceFailed(
                "inference failed after retries (see /metrics faults)")
        return out

    def infer_outputs(self, image: np.ndarray, timeout_s: float = 30.0
                      ) -> Optional[Dict[str, np.ndarray]]:
        """Like ``infer`` but always returns the full name->array output
        dict (every graph output, not just the first)."""
        out = self.infer(image, timeout_s)
        if out is None:
            return None
        return self.unpack_outputs(out)

    def unpack_outputs(self, row: np.ndarray) -> Dict[str, np.ndarray]:
        """Restore the name->array dict from one result row."""
        if len(self._out_names) == 1:
            return {self._out_names[0]: row}
        flat = np.asarray(row).ravel()
        out, off = {}, 0
        for nm, shape in self._out_specs:
            n = int(np.prod(shape))
            out[nm] = flat[off:off + n].reshape(shape)
            off += n
        return out

    # ------------------------------------------------------------------
    def _to_transfer(self, full: np.ndarray):
        if self._transfer_scale is not None:
            return np.clip(np.round(full / self._transfer_scale),
                           -127, 127).astype(np.int8)
        if self._transfer_dtype is not None:
            # numpy has no bfloat16: the cast happens as a tensor
            return torch.from_numpy(np.ascontiguousarray(full)).to(
                self._transfer_dtype)
        return full

    def select_slot(self, n_real: int) -> int:
        """Smallest batch slot that fits ``n_real`` (the
        padding policy: lightly loaded servers run small batches at low
        latency instead of padding up to the full slot)."""
        return next((s for s in self.batch_slots if s >= n_real),
                    self.batch_slots[-1])

    def _dispatch_batch(self, batch: np.ndarray):
        """Assemble + send a batch to the device WITHOUT fetching: on a
        CUDA engine the returned outputs are still being computed, so the
        caller can overlap this batch's transfer+compute with the
        previous batch's fetch."""
        n_real = broadcast_plan(batch.shape[0])
        slot = self.select_slot(n_real)
        if n_real < slot:
            pad = np.zeros((slot - n_real,) + self._item_shape,
                           batch.dtype)
            full = np.concatenate([batch[:n_real], pad])
            self.metrics["pad_images"] += slot - n_real
        else:
            full = batch[:slot]
        if full.dtype != np.int8:       # int8 queues quantized on ingest
            full = self._to_transfer(full)
        outs = self.engine.run({self._in_name: full,
                                **self._extra_inputs})
        return outs, slot, batch.shape[0]

    def _finalize_batch(self, outs, slot: int, nb: int) -> np.ndarray:
        """Fetch the dispatched outputs (the device-to-host copy is the
        sync point)."""
        def host(t):
            return t.float().cpu().numpy()

        if len(self._out_names) == 1:
            out = outs[self._out_names[0]]
            if self._whole_output:
                return host(out)[None]
            out = host(out).reshape(slot, -1)
            return out[:nb].reshape((nb,) + self._result_shape)
        if self._whole_output:                      # one packed row
            return np.concatenate(
                [host(outs[nm]).ravel() for nm in self._out_names])[None]
        parts = [host(outs[nm]).reshape(slot, -1) for nm in self._out_names]
        return np.concatenate(parts, axis=1)[:nb]

    def _run_batch(self, batch: np.ndarray) -> np.ndarray:
        return self._finalize_batch(*self._dispatch_batch(batch))

    def _complete(self, batch, tickets, dispatched, t0,
                  first_failed: bool = False) -> None:
        """Finalize a dispatched batch (or re-run it) under the
        retry/failure policy, post results, book metrics."""
        for attempt in range(self.max_retries + 1):
            try:
                if dispatched is not None:
                    results = self._finalize_batch(*dispatched)
                    dispatched = None    # retries re-run from scratch
                elif first_failed and attempt == 0:
                    raise RuntimeError("dispatch failed")  # consume try
                else:
                    results = self._run_batch(batch)
                self.queue.post_results(tickets, results)
                self._fault_count = 0
                break
            except Exception:
                self.metrics["faults"] += 1
                self._fault_count += 1
                if attempt == self.max_retries:
                    # Mark the tickets failed (the explicit status
                    # ``infer`` raises on), then post filler results
                    # so waiters unblock.
                    with self._failed_lock:
                        for t in tickets:
                            self._failed[t] = True
                    filler = np.zeros(
                        (len(tickets),) + self._result_shape,
                        np.float32)
                    self.queue.post_results(tickets, filler)
                if self._fault_count >= 3:
                    self._healthy.clear()
        self.metrics["batches"] += 1
        self.metrics["images"] += len(tickets)
        self.metrics["batch_latency_ms_sum"] += (time.time() - t0) * 1e3

    def _serve_loop(self) -> None:
        # Double-buffered when pipeline_depth > 1: dispatch batch k+1
        # before fetching batch k, so the next transfer+compute rides
        # behind the previous fetch.  collect() BLOCKS while the queue
        # is empty (both queue impls), so an in-flight batch must drain
        # whenever no new work is queued — otherwise its clients would
        # wait behind an indefinite collect.
        pending = None   # (batch, tickets, dispatched, t0)
        while not self._stop.is_set():
            if pending is not None and self.queue.depth() == 0:
                self._complete(*pending)
                pending = None
            batch, tickets = self.queue.collect(self.batch_size,
                                                self.batch_timeout_us)
            if not tickets:
                if pending is not None:
                    self._complete(*pending)
                    pending = None
                if self._stop.is_set():
                    return
                continue
            t0 = time.time()
            dispatched = None
            failed = False
            if self.pipeline_depth > 1:
                try:
                    dispatched = self._dispatch_batch(batch)
                except Exception:
                    failed = True    # counted in _complete's retry loop
            if pending is not None:
                self._complete(*pending)
                pending = None
            if dispatched is not None:
                pending = (batch, tickets, dispatched, t0)
            else:
                self._complete(batch, tickets, None, t0,
                               first_failed=failed)
        if pending is not None:
            self._complete(*pending)

    def _heartbeat_loop(self) -> None:
        while not self._stop.is_set():
            self._last_heartbeat = time.time()
            time.sleep(0.25)

    # ------------------------------------------------------------------
    def healthy(self) -> bool:
        return (self._healthy.is_set()
                and time.time() - self._last_heartbeat < 5.0)

    def prometheus_text(self) -> str:
        """Gauges in Prometheus exposition format (SURVEY.md §5 metrics;
        dependency-light like the reference's LOGI macros)."""
        lines = []
        for k, v in self.gauges().items():
            if isinstance(v, bool):
                v = int(v)
            if isinstance(v, (int, float)):
                lines.append(f"feathercnn_{k} {v}")
            elif isinstance(v, dict):
                for k2, v2 in v.items():
                    if isinstance(v2, (int, float)):
                        lines.append(f"feathercnn_{k}_{k2} {v2}")
        return "\n".join(lines) + "\n"

    def gauges(self) -> Dict[str, Any]:
        m = dict(self.metrics)
        m["queue_depth"] = self.queue.depth()
        m["healthy"] = self.healthy()
        if m["batches"]:
            m["mean_batch_latency_ms"] = (m["batch_latency_ms_sum"]
                                          / m["batches"])
        if hasattr(self.queue, "stats"):
            m["queue"] = self.queue.stats()
        return m
