"""Offline scoring: `cli/score.score_chunks` over chunks of the pool's videos.

Traffic parameters: `batch` (videos a chunk, the CLI's `--batch_size`),
`frames`, `text_tokens`, `pool` (distinct videos, drawn from the seed),
`warmup_chunks`. The window runs whole chunks: the chunk iterator stops
handing out chunks once `--seconds` have passed, and the window ends when
`score_chunks` has read back the last one. One chunk, drawn from the seed
among those sure to fall in the window, is compared with the reference: its
scores, and what the hooks keep of it (mlp1's output, the motion embedding,
the score head's input).
"""

from __future__ import annotations

import contextlib
import time
from unittest import mock

import numpy as np
import torch

from portbench import inputs, trace

class _Capture:
    """Forward hooks that keep one chunk's intermediate outputs."""

    def __init__(self, model):
        self.active = False
        self.out: dict = {}
        self.handles = [
            model.mlp1.register_forward_hook(self._keep("features")),
            model.motion_mlp.register_forward_hook(self._keep("motion")),
            model.mlpscore.register_forward_pre_hook(
                lambda m, args: self._store("readout", args[0])),
        ]

    def _keep(self, key):
        return lambda m, args, out: self._store(key, out)

    def _store(self, key, t):
        if self.active:
            self.out[key] = t.detach().clone()

    def remove(self):
        for h in self.handles:
            h.remove()


def run(r) -> None:
    from aigv_assessor_torch.cli import score as score_mod

    t = r.cell.traffic
    batch = t["batch"]
    model = r.build_model()
    ids = inputs.prompt_ids(r.cfg, t, r.seed)
    pool = inputs.video_pool(r.cfg, t, r.seed, r.device)
    r.mark("inputs")
    perm = inputs.rng(r.seed, 4).permutation(len(pool))

    def chunk_videos(i):
        return [int(perm[(i * batch + k) % len(pool)]) for k in range(batch)]

    ids_pn = ids[None]
    mask_pn = np.ones_like(ids_pn, dtype=bool)
    capture = _Capture(model)
    state = {"chunks": 0, "stop_at": None, "sample": -1}

    def chunks(n_max=None):
        i = 0
        while n_max is None or i < n_max:
            if state["stop_at"] is not None and time.perf_counter() >= state["stop_at"]:
                return
            capture.active = i == state["sample"]
            state["chunks"] = i + 1
            yield [pool[j] for j in chunk_videos(i)]
            i += 1

    def score(n_max=None):
        return score_chunks(model, chunks(n_max), ids_pn, mask_pn, batch_size=batch)

    score_chunks = score_mod.score_chunks
    t_warm = time.perf_counter()
    score(t["warmup_chunks"])
    r.sync()
    chunk_s = (time.perf_counter() - t_warm) / t["warmup_chunks"]
    # the compared chunk: drawn among those the window surely reaches
    safe = max(1, int(0.5 * r.seconds / max(chunk_s, 1e-6)))
    state["sample"] = int(inputs.rng(r.seed, 5).integers(safe))

    enqueue_s = []
    real_score_batch = score_mod.score_batch

    def timed_score_batch(*args, **kw):
        t0 = time.perf_counter()
        out = real_score_batch(*args, **kw)
        enqueue_s.append(time.perf_counter() - t0)
        return out

    handles = trace.hook_modules(model, trace.MODULES) if r.trace else []
    patch = (mock.patch.object(score_mod, "score_batch", timed_score_batch) if r.trace
             else contextlib.nullcontext())
    r.start_window()
    with patch, trace.profile_window(r.trace) as prof:
        t0 = time.perf_counter()
        state["stop_at"] = t0 + r.seconds
        rows = score()
        r.sync()
        t1 = time.perf_counter()
    r.end_window()
    for h in handles:
        h.remove()
    capture.remove()
    if capture.out.keys() != {"features", "motion", "readout"}:
        raise RuntimeError(f"the compared chunk {state['sample']} was not captured "
                           f"({state['chunks']} chunks ran)")

    scores = np.asarray(rows, dtype=np.float64)[:, 0] / 100.0  # the CLI's MOS scale
    n = len(rows)
    r.window_s = t1 - t0
    r.attempted = n
    r.failed = int((~np.isfinite(scores)).sum())
    r.raw.update(videos=n, enqueue_s=enqueue_s,
                 summary=prof.get("summary"))
    s = state["sample"]
    videos = chunk_videos(s)
    cap = capture.out
    r.compare = {
        "ids": ids,
        "pixels": pool[videos],
        "program": {
            "features": cap["features"].reshape(batch, -1, cap["features"].shape[-1]),
            "motion": cap["motion"].reshape(batch, -1),
            "readout": cap["readout"].reshape(batch, -1),
            "score": torch.as_tensor(scores[s * batch:(s + 1) * batch]),
        },
    }
    del model, capture, cap
