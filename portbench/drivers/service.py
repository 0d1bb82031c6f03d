"""Online scoring: an open loop of arrivals into `cli/serve.ScoringService.submit`.

Traffic parameters: `batch` and `max_wait_ms` (the service's), `frames`,
`text_tokens`, `pool` (distinct videos, drawn from the seed), `rate_per_s`
(fixed, below the highest rate the service sustains), `clients` (threads
that wait on `submit`, enough that none is ever short), `warmup_batches`,
`check_requests` (how many answers, drawn from the seed, are compared with
the reference: their scores, and the motion embedding and score-head input
that the hooks kept of each).

The HTTP handler and the video decode are bypassed: each request hands
`submit` a decoded uint8 video from the pool. The service is given the
benchmark's model (through its `build_serving_stack`) and the benchmark's
prompt (its ids and mask) before its warm-up. A request's latency runs from
its scheduled send time to the return of `submit`; the window runs from the
first send time until every request due in it has returned.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import ThreadPoolExecutor, wait
from unittest import mock

import numpy as np
import torch

from portbench import inputs, trace

QUESTION = "How would you rate the quality of this video?"
STATS = ("batches", "jobs", "linger_s", "assemble_s", "flush_s")


class _Tokenizer:
    """What the service asks of a tokenizer; its prompt is replaced below."""

    pad_token_id = 2

    def encode(self, text):
        return [1] * 8


class _Capture:
    """Which requests each batch held, with the batch's motion embeddings and
    score-head inputs: wrappers of the service's `_upload` (on the client's
    thread, which tags the job with its request) and `_score` (on the
    worker's), and forward hooks on `motion_mlp` and `mlpscore`."""

    def __init__(self, svc):
        self.local = threading.local()
        self.rows: dict = {}  # request -> (motion, readout) rows
        self._batch = None
        real_upload, real_score = svc._upload, svc._score

        def upload(pixels):
            job = real_upload(pixels)
            job.portbench_request = getattr(self.local, "request", None)
            return job

        def score(jobs):
            self._batch = {}
            try:
                return real_score(jobs)
            finally:
                b, self._batch = self._batch, None
                for k, job in enumerate(jobs):
                    if job.portbench_request is not None:
                        self.rows[job.portbench_request] = (b["motion"][k], b["readout"][k])

        svc._upload, svc._score = upload, score
        self.handles = [
            svc.model.motion_mlp.register_forward_hook(
                lambda m, args, out: self._keep("motion", out)),
            svc.model.mlpscore.register_forward_pre_hook(
                lambda m, args: self._keep("readout", args[0])),
        ]

    def _keep(self, key, t):
        if self._batch is not None:
            self._batch[key] = t.detach().reshape(t.shape[0], -1).clone()

    def remove(self):
        for h in self.handles:
            h.remove()


def _stats(svc) -> dict:
    with svc.stats._lock:
        return {k: getattr(svc.stats, k) for k in STATS}


def run(r) -> None:
    from aigv_assessor_torch.cli import serve as serve_mod

    t = r.cell.traffic
    batch = t["batch"]
    model = r.build_model()
    ids = inputs.prompt_ids(r.cfg, t, r.seed)
    pool = inputs.video_pool(r.cfg, t, r.seed, r.device)
    r.mark("inputs")
    stack = (model.config, model, _Tokenizer())
    with mock.patch.object(serve_mod, "build_serving_stack", lambda **kw: stack):
        svc = serve_mod.ScoringService([QUESTION], batch_size=batch,
                                       num_segments=t["frames"], max_wait_ms=t["max_wait_ms"],
                                       device=r.device)
    del model, stack
    svc._ids = torch.as_tensor(np.tile(ids[None, None], (batch, 1, 1)), device=r.device)
    svc._mask = torch.ones(svc._ids.shape, dtype=torch.bool, device=r.device)
    svc.prefix_len = 0
    r.sync()

    arrivals = inputs.arrival_times(t["rate_per_s"], r.seconds, r.seed)
    n = len(arrivals)
    video_of = inputs.rng(r.seed, 6).integers(0, len(pool), n)
    latency = np.full(n, np.inf)
    lateness = np.zeros(n)
    done_at = np.zeros(n)
    scores = np.full(n, np.nan)

    capture = _Capture(svc)

    def one(i, due):
        lateness[i] = time.perf_counter() - due
        capture.local.request = i
        scores[i] = svc.submit(pool[video_of[i]])[0]
        done_at[i] = time.perf_counter()
        latency[i] = done_at[i] - due

    handles = []
    ex = ThreadPoolExecutor(max_workers=t["clients"])
    try:
        svc.warmup()
        for w in range(t["warmup_batches"]):
            for f in [ex.submit(svc.submit, pool[(w * batch + k) % len(pool)])
                      for k in range(batch)]:
                f.result()
        handles = trace.hook_modules(svc.model, trace.MODULES) if r.trace else []
        s0 = _stats(svc)
        r.start_window()
        with trace.profile_window(r.trace) as prof:
            t0 = time.perf_counter()
            futures = []
            for i, a in enumerate(arrivals):
                delay = t0 + a - time.perf_counter()
                if delay > 0:
                    time.sleep(delay)
                futures.append(ex.submit(one, i, t0 + a))
            wait(futures, timeout=r.seconds + 60)
            r.sync()
            t1 = time.perf_counter()
        r.end_window()
        s1 = _stats(svc)
    finally:
        for h in handles + capture.handles:
            h.remove()
        svc.close()  # fails what is still queued, so no client waits on
        ex.shutdown(wait=True)
    r.window_s = (done_at.max() if np.all(done_at > 0) else t1) - t0
    r.attempted = n
    r.failed = int((~np.isfinite(scores)).sum())  # a request that raised keeps its NaN
    delta = {k: s1[k] - s0[k] for k in STATS}
    r.raw.update(latency_s=latency, lateness_s=lateness, service=delta, videos=n,
                 summary=prof.get("summary"))
    idx = inputs.sample(r.seed, 7, n, t["check_requests"])
    r.compare = {
        "ids": ids,
        "pixels": pool[video_of[idx]],
        "program": {
            "score": torch.as_tensor(scores[idx] / 100.0),  # the service's MOS scale
            "motion": torch.stack([capture.rows[i][0] for i in idx]),
            "readout": torch.stack([capture.rows[i][1] for i in idx]),
        },
    }
    del svc
