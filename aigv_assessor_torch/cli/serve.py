"""HTTP video-scoring service (`aigv_assessor_tpu/cli/serve.py`), the
online path beside the offline `cli/score.py`: a threading HTTP server in
front of a micro-batching device worker.

    python -m aigv_assessor_torch.cli.serve --model_scale 2b --port 8760 \
        --batch_size 4 --question "How would you rate the static quality of this video?"

Flags as the JAX CLI's, plus `--device` (default `cuda`; `--device cpu
--bf16 False` on a machine without a card).

- Requests park on a queue. The worker thread, the only thread that
  launches kernels, collects up to `--batch_size` videos, lingering until
  the first one's deadline (`--max_wait_ms`), pads the group to the batch
  with its last video, and scores it as the offline CLI does: uint8 frames
  normalized on the device (`ops/preprocess.resize_normalize`), then every
  question off one encode of the frames
  (`AIGVAssessor.score_perspectives`, on the questions' shared prefix when
  they have one).
- Video decode runs on the HTTP handler threads, so it overlaps the device:
  the native decoder (`data/native_decode`) when its library loads, else
  OpenCV / PIL with a bicubic resize to the model's input size (or the
  host's fp32 `transform_frames` with `--device_preprocess False`). The
  service logs which decoder it has.
- Frames cross to the card as uint8 from pinned memory, copied on a stream
  of their own on the handler thread; the worker's stream waits on the
  copy's event before it stacks the batch.
- The worker is a one-deep pipeline: batch N's scores are read back only
  after batch N+1 is launched. Each batch ends with a non-blocking copy of
  its [B, P] scores into pinned memory and an event after it, and the
  readback waits on that event alone, not on the batch behind it.
- One batch shape serves every request; `warmup` runs one whole batch
  before the server listens, so that the kernels are built (nvcc, at their
  first use) before the first request.

Endpoints:
  GET  /healthz  -> {"status": "ok", "questions", "batch_size", "num_segments"}
  GET  /statz    -> where the online time goes (`_Stats.snapshot`)
  POST /score    -> body = raw video bytes (mp4 / gif / webm by Content-Type),
                    or JSON {"path": "/local/file"}; reply
                    {"scores": {question: mos_scaled_score, ...}}
"""

from __future__ import annotations

import argparse
import contextlib
import json
import logging
import os
import queue
import tempfile
import threading
import time
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional

import numpy as np
import torch

from aigv_assessor_torch.cli.args import _bool
from aigv_assessor_torch.cli.common import build_serving_stack
from aigv_assessor_torch.cli.score import build_prompt_ids, compute_shared_prefix_len
from aigv_assessor_torch.data import native_decode
from aigv_assessor_torch.data.video import frames_to_uint8, load_video, transform_frames
from aigv_assessor_torch.ops.preprocess import resize_normalize

logger = logging.getLogger(__name__)

CLOSED = "service closed before the job was scored"


@dataclass
class _Job:
    pixels: torch.Tensor  # [T, H, W, 3] on the service's device
    ready: Optional[torch.cuda.Event] = None  # the upload's copy, on a card
    done: threading.Event = field(default_factory=threading.Event)
    scores: Optional[np.ndarray] = None  # [P] on success
    error: Optional[str] = None


class _Stats:
    """Where the online time goes, accumulated by the worker and the decode
    path and read through /statz: batch underfill against host decode
    against waiting on the device."""

    def __init__(self):
        self._lock = threading.Lock()
        self.batches = 0
        self.jobs = 0  # real (not padding) jobs over all batches
        self.linger_s = 0.0  # worker: waiting for the batch to fill after its first job
        self.assemble_s = 0.0  # worker: stack, normalize and launch the batch
        self.flush_s = 0.0  # worker: waiting for a batch's scores
        self.idle_s = 0.0  # worker: queue timeouts with nothing pending
        self.decode_s = 0.0  # handler threads: decode and resize
        self.decodes = 0

    def add(self, **kw) -> None:
        with self._lock:
            for k, v in kw.items():
                setattr(self, k, getattr(self, k) + v)

    def snapshot(self, batch_size: int) -> dict:
        with self._lock:
            b = max(self.batches, 1)
            return {
                "batches": self.batches,
                "jobs": self.jobs,
                "mean_batch_fill": round(self.jobs / b, 3),
                "batch_capacity": batch_size,
                "linger_s_per_batch": round(self.linger_s / b, 4),
                "assemble_s_per_batch": round(self.assemble_s / b, 4),
                "flush_s_per_batch": round(self.flush_s / b, 4),
                "idle_s_total": round(self.idle_s, 3),
                "decodes": self.decodes,
                "decode_s_mean": round(self.decode_s / max(self.decodes, 1), 4),
            }


class ScoringService:
    """Micro-batching wrapper around the perspective scorer: `submit` blocks
    until the worker has scored the caller's video inside a padded batch.

    `device` is where the model runs; "cuda" without a card raises, it
    does not move to the CPU."""

    def __init__(
        self,
        questions: List[str],
        model_name_or_path: str = "",
        model_scale: str = "auto",
        batch_size: int = 8,
        num_segments: int = 8,
        max_wait_ms: float = 30.0,
        bf16: bool = True,
        int8: bool = False,
        int4: bool = False,
        w8a8: bool = False,
        mos_scale: float = 100.0,
        shared_prefix: bool = True,
        max_seq_length: int = 4096,
        device_preprocess: bool = True,
        device: torch.device | str = "cuda",
    ):
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        if self.cuda and not torch.cuda.is_available():
            raise RuntimeError(f"ScoringService(device={str(device)!r}): no CUDA card here; "
                               "pass device='cpu' to serve on the CPU")
        config, model, tokenizer = build_serving_stack(
            model_name_or_path=model_name_or_path, model_scale=model_scale,
            max_seq_length=max_seq_length, bf16=bf16, int8=int8, int4=int4, w8a8=w8a8,
            device=self.device)
        self.model = model
        self.questions = questions
        self.batch_size = batch_size
        self.num_segments = num_segments
        self.max_wait = max_wait_ms / 1e3
        self.mos_scale = mos_scale
        self.image_size = config.force_image_size or config.vision.image_size
        self.device_preprocess = device_preprocess
        self.decoder = ("native libvideodec.so" if native_decode.available()
                        else "OpenCV / PIL (native libvideodec.so not loaded)")
        logger.info("video decode on the handler threads: %s", self.decoder)

        prompts = [build_prompt_ids(tokenizer, config.template, q, num_segments,
                                    config.num_image_token) for q in questions]
        max_n = max(len(p) for p in prompts)
        ids = np.full((len(prompts), max_n), tokenizer.pad_token_id, np.int64)
        mask = np.zeros((len(prompts), max_n), bool)
        for i, p in enumerate(prompts):
            ids[i, : len(p)] = p
            mask[i, : len(p)] = True
        self.prefix_len = (compute_shared_prefix_len(prompts, config.img_context_token_id)
                           if shared_prefix else 0)
        self._ids = torch.as_tensor(np.tile(ids[None], (batch_size, 1, 1)), device=self.device)
        self._mask = torch.as_tensor(np.tile(mask[None], (batch_size, 1, 1)),
                                     device=self.device)
        # uploads (handler threads) and batches (the worker) each on a stream
        # of their own
        self._copy_stream = torch.cuda.Stream(self.device) if self.cuda else None
        self._stream = torch.cuda.Stream(self.device) if self.cuda else None
        if self.cuda:  # the weights, ids and mask were made on the default stream
            torch.cuda.synchronize(self.device)

        self.stats = _Stats()
        self._q: "queue.Queue[_Job]" = queue.Queue()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._device_loop, daemon=True)
        self._thread.start()

    # ------------------------------------------------------------ public ---

    def warmup(self) -> None:
        """One whole batch before serving traffic: the kernels build at their
        first use."""
        px = np.zeros((self.num_segments, self.image_size, self.image_size, 3),
                      np.uint8 if self.device_preprocess else np.float32)
        self.submit(px)

    def decode(self, path: str) -> np.ndarray:
        t0 = time.monotonic()
        try:
            return self._decode(path)
        finally:
            self.stats.add(decode_s=time.monotonic() - t0, decodes=1)

    def _decode(self, path: str) -> np.ndarray:
        s = self.image_size
        if (self.device_preprocess and "cogvideo" not in path
                and not path.lower().endswith(".gif") and not os.path.isdir(path)
                and native_decode.available()):
            # the native decoder scales while it decodes: [T, s, s, 3] uint8
            # in one pass
            try:
                return np.stack(native_decode.sample_frames(path, self.num_segments,
                                                            out_size=(s, s)))
            except IOError:
                pass  # the OpenCV / PIL path below
        frames = load_video(path, num_segments=self.num_segments)
        if self.device_preprocess:
            # uint8 at the input size; the normalization runs on the device
            return frames_to_uint8(frames, input_size=s)
        return transform_frames(frames, input_size=s)

    def submit(self, pixels: np.ndarray) -> np.ndarray:
        """Blocks until scored -> [P] float scores (times `mos_scale`)."""
        if self._stop.is_set():
            raise RuntimeError("service is closed")
        job = self._upload(pixels)
        self._q.put(job)
        if self._stop.is_set() and not job.done.is_set():
            # close() may have drained the queue between the check above and
            # the put: fail the job here rather than park on done.wait()
            job.error = CLOSED
            job.done.set()
        job.done.wait()
        if job.error is not None:
            raise RuntimeError(job.error)
        return job.scores

    def _upload(self, pixels: np.ndarray) -> _Job:
        """The frames on the device, copied on the handler thread: from pinned
        memory on the copy stream, with the event the worker waits on."""
        host = torch.from_numpy(np.ascontiguousarray(pixels))
        if not self.cuda:
            return _Job(pixels=host.to(self.device))
        host = host.pin_memory()
        with torch.cuda.stream(self._copy_stream):
            dev = host.to(self.device, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record(self._copy_stream)
        return _Job(pixels=dev, ready=ready)

    def close(self) -> None:
        self._stop.set()
        # the worker exits without draining: fail what is queued, and the
        # worker completes its pending batch, so that no submit() caller
        # parks forever. Loop until the worker has exited: one timed join
        # could return while a first batch builds its kernels.
        while True:
            self._thread.join(timeout=5)
            while True:
                try:
                    job = self._q.get_nowait()
                except queue.Empty:
                    break
                job.error = CLOSED
                job.done.set()
            if not self._thread.is_alive():
                break

    # ------------------------------------------------------------ device ---

    def _score(self, jobs: List[_Job]):
        """Launch one padded batch on the worker's stream -> (scores in host
        memory, the event after their copy)."""
        for job in jobs:
            if job.ready is not None:
                self._stream.wait_event(job.ready)
                job.pixels.record_stream(self._stream)
        pixels = [job.pixels for job in jobs]
        pixels = torch.stack(pixels + [pixels[-1]] * (self.batch_size - len(pixels)))
        dtype = self.model.precision.compute_dtype
        if pixels.dtype == torch.uint8:
            pixel_values = resize_normalize(pixels, size=pixels.shape[-2], dtype=dtype)
        else:
            pixel_values = pixels.to(dtype)
        scores = self.model.score_perspectives(self._ids, pixel_values, self._mask,
                                               shared_prefix_len=self.prefix_len or None)
        host = torch.empty(scores.shape, dtype=torch.float32, pin_memory=self.cuda)
        host.copy_(scores, non_blocking=self.cuda)
        done = None
        if self.cuda:
            done = torch.cuda.Event()
            done.record(self._stream)
        return host, done

    def _flush(self, pending) -> None:
        jobs, host, done = pending
        t0 = time.monotonic()
        if done is not None:
            done.synchronize()  # this batch's copy, not the batch launched after it
        scores = host.numpy()
        self.stats.add(flush_s=time.monotonic() - t0)
        for i, job in enumerate(jobs):
            job.scores = scores[i] * self.mos_scale
            job.done.set()

    def _fail(self, jobs: List[_Job], error: str) -> None:
        for job in jobs:
            if not job.done.is_set():
                job.error = error
                job.done.set()

    def _device_loop(self) -> None:
        stream = torch.cuda.stream(self._stream) if self.cuda else contextlib.nullcontext()
        with stream, torch.inference_mode():
            pending = None  # (jobs, scores, event): read back one batch late
            while not self._stop.is_set():
                t_idle = time.monotonic()
                try:
                    first = self._q.get(timeout=0.1)
                except queue.Empty:
                    if pending is not None:
                        self._flush(pending)
                        pending = None
                    else:
                        self.stats.add(idle_s=time.monotonic() - t_idle)
                    continue
                jobs = [first]
                # linger until the first job's deadline, taking whatever
                # arrives: decodes that end on different handler threads
                # still share a batch
                t_linger = time.monotonic()
                deadline = t_linger + self.max_wait
                while len(jobs) < self.batch_size:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        break
                    try:
                        jobs.append(self._q.get(timeout=remaining))
                    except queue.Empty:
                        break
                t_asm = time.monotonic()
                try:
                    host, done = self._score(jobs)
                    t_done = time.monotonic()
                    self.stats.add(batches=1, jobs=len(jobs), linger_s=t_asm - t_linger,
                                   assemble_s=t_done - t_asm)
                    # one-deep pipeline: read the previous batch back while
                    # this one runs
                    if pending is not None:
                        self._flush(pending)
                    pending = (jobs, host, done)
                except Exception as e:  # the callers get the error; nothing retries
                    logger.exception("scoring batch failed")
                    self._fail(jobs, repr(e))
            if pending is not None:  # its work already ran: complete it
                try:
                    self._flush(pending)
                except Exception as e:
                    logger.exception("reading back the last batch failed")
                    self._fail(pending[0], repr(e))


class _Server(ThreadingHTTPServer):
    # the default listen backlog (5) resets connections under concurrent load
    request_queue_size = 128
    daemon_threads = True


def make_handler(service: ScoringService):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *a):  # through logging, not stderr
            logger.debug("http: " + fmt, *a)

        def _reply(self, code: int, payload: dict) -> None:
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._reply(200, {"status": "ok", "questions": service.questions,
                                  "batch_size": service.batch_size,
                                  "num_segments": service.num_segments})
            elif self.path == "/statz":
                self._reply(200, service.stats.snapshot(service.batch_size))
            else:
                self._reply(404, {"error": "unknown path"})

        def do_POST(self):
            if self.path != "/score":
                self._reply(404, {"error": "unknown path"})
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                body = self.rfile.read(n)
                ctype = self.headers.get("Content-Type", "")
                if ctype.startswith("application/json"):
                    pixels = service.decode(json.loads(body)["path"])
                else:
                    # raw video bytes through a temporary file: the readers
                    # pick the decoder by suffix (mp4 unless said otherwise)
                    suffix = {"image/gif": ".gif", "video/webm": ".webm"}.get(ctype, ".mp4")
                    with tempfile.NamedTemporaryFile(suffix=suffix, delete=False) as f:
                        f.write(body)
                        tmp = f.name
                    try:
                        pixels = service.decode(tmp)
                    finally:
                        os.unlink(tmp)
                scores = service.submit(pixels)
                self._reply(200, {"scores": {q: float(s)
                                             for q, s in zip(service.questions, scores)}})
            except Exception as e:  # the request fails, the server goes on
                logger.exception("score request failed")
                self._reply(400, {"error": repr(e)[:300]})

    return Handler


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--model_name_or_path", default="")
    ap.add_argument("--model_scale", default="auto", choices=["auto", "tiny", "2b", "8b"])
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=8760)
    ap.add_argument("--question", action="append", default=None)
    ap.add_argument("--batch_size", type=int, default=8)
    ap.add_argument("--num_segments", type=int, default=8)
    ap.add_argument("--max_wait_ms", type=float, default=30.0)
    ap.add_argument("--bf16", type=_bool, default=True)
    ap.add_argument("--int8", type=_bool, default=False)
    ap.add_argument("--int4", type=_bool, default=False)
    ap.add_argument("--w8a8", type=_bool, default=False)
    ap.add_argument("--mos_scale", type=float, default=100.0)
    ap.add_argument("--max_seq_length", type=int, default=4096)
    ap.add_argument("--device_preprocess", type=_bool, default=True,
                    help="uint8 host decode and resize, the normalization on the device; "
                         "False = the host's fp32 transform")
    ap.add_argument("--device", default="cuda", help="torch device to serve on (cpu for tests)")
    args = ap.parse_args(argv)

    service = ScoringService(
        questions=args.question or ["How would you rate the static quality of this video?"],
        model_name_or_path=args.model_name_or_path,
        model_scale=args.model_scale,
        batch_size=args.batch_size,
        num_segments=args.num_segments,
        max_wait_ms=args.max_wait_ms,
        bf16=args.bf16,
        int8=args.int8,
        int4=args.int4,
        w8a8=args.w8a8,
        mos_scale=args.mos_scale,
        max_seq_length=args.max_seq_length,
        device_preprocess=args.device_preprocess,
        device=args.device,
    )
    logger.info("warming up: one batch, the kernels built at their first use")
    service.warmup()
    server = _Server((args.host, args.port), make_handler(service))
    logger.info("serving on %s:%d", args.host, server.server_address[1])
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.shutdown()
        service.close()


if __name__ == "__main__":
    main()
