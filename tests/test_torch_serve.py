"""The port's HTTP scoring service (`aigv_assessor_torch/cli/serve.py`)
against the JAX package's, on the CPU.

Both services run the tiny stage-2 model in fp32 with two questions, batch
4 and 4 frames, on one JAX tree carried across with `state_dict_from_jax`
(JAX's `init_or_load_params` and the port's `model_weights` both hand it
out), its score head made non-negative so that the readout reaches the
scores. One service of each package per module.

- Each video's scores / `mos_scale` within SCORE_TOL = 2e-4 of JAX's (the
  fp32 slice tolerance of tests/test_torch_models.py), for uint8 frames
  (normalized on the device) and fp32 frames; on the shared prefix and off
  it within the same; the decoded frames equal JAX's.
- 6 concurrent submits equal to 6 single ones within BATCH_TOL = 1e-5 (the
  JAX test's bound): every caller gets its own video's scores.
- HTTP: /healthz, /statz with JAX's keys, raw GIF bytes and a {"path"}
  body scored as JAX scores the same file, 400 on a bad body, 404 on an
  unknown path; `python -m aigv_assessor_torch.cli.serve --device cpu`
  answers on a port and exits on SIGINT.
- `close()` with jobs queued returns and fails them; a batch whose forward
  raises fails its jobs with the error, and nothing retries it; with no
  card, `ScoringService(device="cuda")` raises.
"""

from tests import _torch_threads  # noqa: F401  (before torch does work)
import http.client
import io
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from aigv_assessor_torch.cli import common as t_common
from aigv_assessor_torch.cli import serve as t_serve
from aigv_assessor_torch.models.loading import state_dict_from_jax
from aigv_assessor_tpu.cli import common as j_common
from aigv_assessor_tpu.cli import serve as j_serve
from tests._torch_cli_fixtures import jit_init, open_tree

SCORE_TOL = 2e-4
BATCH_TOL = 1e-5
QUESTIONS = ["How would you rate the static quality of this video?",
             "How would you rate the temporal quality of this video?"]
BATCH, T, MAX_LEN = 4, 4, 512
SERVICE_KW = dict(questions=QUESTIONS, model_scale="tiny", batch_size=BATCH, num_segments=T,
                  max_wait_ms=20.0, bf16=False, max_seq_length=MAX_LEN)
TIMEOUT = 120


@pytest.fixture(scope="module")
def tree():
    """The tiny stage-2 tree JAX's serving stack draws from seed 0, with a
    non-negative score head."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_common, "init_or_load_params", jit_init)
        _, _, params, _ = j_common.build_serving_stack(model_scale="tiny", bf16=False,
                                                       max_seq_length=MAX_LEN)
    return open_tree(params)


def port_service(tree, **kw):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(t_common, "model_weights",
                   lambda args, config: state_dict_from_jax(tree, config))
        return t_serve.ScoringService(**{**SERVICE_KW, "device": "cpu", **kw})


@pytest.fixture(scope="module")
def jax_service(tree):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_common, "init_or_load_params", lambda model, args, config, seed=0: tree)
        svc = j_serve.ScoringService(**SERVICE_KW)
    yield svc
    svc.close()


@pytest.fixture(scope="module")
def service(tree):
    svc = port_service(tree)
    svc.warmup()
    yield svc
    svc.close()


def frames(svc, seed, dtype):
    rng = np.random.default_rng(seed)
    shape = (svc.num_segments, svc.image_size, svc.image_size, 3)
    if dtype == "uint8":
        return rng.integers(0, 256, shape, dtype=np.uint8)
    return rng.normal(size=shape).astype(np.float32)


def gif_bytes():
    from PIL import Image

    imgs = [Image.new("RGB", (64, 48), (i * 40 % 255, 80, 120)) for i in range(6)]
    buf = io.BytesIO()
    imgs[0].save(buf, format="GIF", save_all=True, append_images=imgs[1:], duration=100)
    return buf.getvalue()


def assert_scores_close(got, want, tol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape == (len(QUESTIONS),)
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got / 100.0, want / 100.0, rtol=0, atol=tol)


# ------------------------------------------------------------ scoring ---


@pytest.mark.parametrize("dtype", ["uint8", "fp32"])
def test_scores_equal_jax(service, jax_service, dtype):
    """uint8 frames are normalized on the device, fp32 ones taken as they
    are; either way each video's scores are JAX's."""
    assert service.image_size == jax_service.image_size
    got = [service.submit(frames(service, s, dtype)) for s in range(3)]
    want = [jax_service.submit(frames(service, s, dtype)) for s in range(3)]
    for g, w in zip(got, want):
        assert_scores_close(g, w, SCORE_TOL)
    assert np.ptp(np.asarray(got)) > 0  # the head is open: the videos differ


def test_shared_prefix_on_and_off(service, tree):
    assert service.prefix_len > 0  # the questions share the frames' prefix
    unshared = port_service(tree, shared_prefix=False)
    try:
        assert unshared.prefix_len == 0
        for s in range(2):
            px = frames(service, 10 + s, "uint8")
            assert_scores_close(service.submit(px), unshared.submit(px), SCORE_TOL)
    finally:
        unshared.close()


def test_concurrent_submits_equal_single(service):
    """Six concurrent callers share padded batches; each gets its own video's
    scores."""
    inputs = [frames(service, 20 + s, "uint8") for s in range(6)]
    solo = [service.submit(px) for px in inputs]
    results = [None] * len(inputs)

    def run(i):
        results[i] = service.submit(inputs[i])

    threads = [threading.Thread(target=run, args=(i,)) for i in range(len(inputs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=TIMEOUT)
    assert not any(t.is_alive() for t in threads)
    for got, want in zip(results, solo):
        assert got is not None
        np.testing.assert_allclose(got, want, rtol=BATCH_TOL, atol=BATCH_TOL)
    snap = service.stats.snapshot(BATCH)
    assert snap["jobs"] >= snap["batches"] > 0 and 0 < snap["mean_batch_fill"] <= BATCH


@pytest.mark.parametrize("device_preprocess", [True, False], ids=["uint8", "fp32"])
def test_decode_equals_jax(service, jax_service, tmp_path, monkeypatch, device_preprocess):
    path = tmp_path / "clip.gif"
    path.write_bytes(gif_bytes())
    monkeypatch.setattr(service, "device_preprocess", device_preprocess)
    monkeypatch.setattr(jax_service, "device_preprocess", device_preprocess)
    got, want = service.decode(str(path)), jax_service.decode(str(path))
    assert got.dtype == want.dtype == (np.uint8 if device_preprocess else np.float32)
    np.testing.assert_array_equal(got, want)


# ----------------------------------------------------------------- HTTP ---


@pytest.fixture(scope="module")
def server(service):
    srv = t_serve._Server(("127.0.0.1", 0), t_serve.make_handler(service))
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    yield srv.server_address
    srv.shutdown()
    srv.server_close()


def request(address, method, path, body=None, headers=None):
    conn = http.client.HTTPConnection(*address, timeout=TIMEOUT)
    try:
        conn.request(method, path, body=body, headers=headers or {})
        r = conn.getresponse()
        return r.status, json.loads(r.read())
    finally:
        conn.close()


def test_healthz_and_statz(server, service, jax_service):
    status, body = request(server, "GET", "/healthz")
    assert status == 200
    assert body == {"status": "ok", "questions": QUESTIONS, "batch_size": BATCH,
                    "num_segments": T}
    status, body = request(server, "GET", "/statz")
    assert status == 200
    assert set(body) == set(jax_service.stats.snapshot(BATCH))
    assert body["batch_capacity"] == BATCH and body["batches"] >= 1


def test_score_raw_gif_bytes_equals_jax(server, jax_service, tmp_path):
    status, body = request(server, "POST", "/score", body=gif_bytes(),
                           headers={"Content-Type": "image/gif"})
    assert status == 200, body
    path = tmp_path / "clip.gif"
    path.write_bytes(gif_bytes())
    want = jax_service.submit(jax_service.decode(str(path)))
    assert list(body["scores"]) == QUESTIONS
    assert_scores_close([body["scores"][q] for q in QUESTIONS], want, SCORE_TOL)


def test_score_local_path(server, service, tmp_path):
    path = tmp_path / "clip.gif"
    path.write_bytes(gif_bytes())
    status, body = request(server, "POST", "/score", body=json.dumps({"path": str(path)}),
                           headers={"Content-Type": "application/json"})
    assert status == 200, body
    want = service.submit(service.decode(str(path)))
    assert_scores_close([body["scores"][q] for q in QUESTIONS], want, BATCH_TOL)


def test_bad_request_and_unknown_path(server):
    status, body = request(server, "POST", "/score", body=b'{"nope": 1}',
                           headers={"Content-Type": "application/json"})
    assert status == 400 and "error" in body
    assert request(server, "GET", "/nope")[0] == 404
    assert request(server, "POST", "/nope", body=b"x")[0] == 404


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_serve_cli_answers_on_a_port(tmp_path):
    """The entry point a user runs, on the CPU: it warms up, listens, scores
    a GIF, and exits cleanly on SIGINT."""
    port = free_port()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {**os.environ, "PYTHONPATH": repo + os.pathsep + os.environ.get("PYTHONPATH", "")}
    proc = subprocess.Popen(
        [sys.executable, "-m", "aigv_assessor_torch.cli.serve", "--model_scale", "tiny",
         "--device", "cpu", "--bf16", "False", "--num_segments", str(T), "--batch_size", "2",
         "--max_seq_length", str(MAX_LEN), "--host", "127.0.0.1", "--port", str(port)],
        cwd=str(tmp_path), env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
    try:
        deadline = time.monotonic() + TIMEOUT
        while True:
            assert proc.poll() is None, proc.stderr.read().decode()[-2000:]
            try:
                status, body = request(("127.0.0.1", port), "GET", "/healthz")
                break
            except OSError:
                assert time.monotonic() < deadline, "the server never listened"
                time.sleep(0.5)
        assert status == 200 and body["batch_size"] == 2
        status, body = request(("127.0.0.1", port), "POST", "/score", body=gif_bytes(),
                               headers={"Content-Type": "image/gif"})
        assert status == 200 and np.isfinite(list(body["scores"].values())).all(), body
        proc.send_signal(signal.SIGINT)
        assert proc.wait(timeout=TIMEOUT) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        proc.stderr.close()


# ------------------------------------------------------ failure paths ---


def test_close_fails_queued_jobs(tree):
    """The worker is held inside a batch while two more jobs queue; close()
    fails the queued ones, the held batch completes, and every caller
    returns."""
    svc = port_service(tree)
    gate, entered = threading.Event(), threading.Event()
    forward = svc.model.score_perspectives

    def held(*a, **kw):
        entered.set()
        assert gate.wait(TIMEOUT)
        return forward(*a, **kw)

    svc.model.score_perspectives = held
    results = {}

    def run(i):
        try:
            results[i] = svc.submit(frames(svc, 30 + i, "uint8"))
        except RuntimeError as e:
            results[i] = e

    first = threading.Thread(target=run, args=(0,))
    first.start()
    assert entered.wait(TIMEOUT)
    queued = [threading.Thread(target=run, args=(i,)) for i in (1, 2)]
    for t in queued:
        t.start()
    deadline = time.monotonic() + TIMEOUT
    while svc._q.qsize() < 2:
        assert time.monotonic() < deadline, "the jobs never queued"
        time.sleep(0.01)
    closer = threading.Thread(target=svc.close)
    closer.start()
    for t in queued:
        t.join(timeout=TIMEOUT)
    assert not any(t.is_alive() for t in queued)
    for i in (1, 2):
        assert isinstance(results[i], RuntimeError) and "closed" in str(results[i])
    gate.set()
    for t in (first, closer):
        t.join(timeout=TIMEOUT)
        assert not t.is_alive()
    assert not svc._thread.is_alive()
    assert np.isfinite(results[0]).all()
    with pytest.raises(RuntimeError, match="closed"):
        svc.submit(frames(svc, 0, "uint8"))


def test_failed_batch_fails_its_jobs(tree):
    svc = port_service(tree)
    calls = []

    def broken(*a, **kw):
        calls.append(1)
        raise ValueError("forward failed")

    svc.model.score_perspectives = broken
    try:
        with pytest.raises(RuntimeError, match="forward failed"):
            svc.submit(frames(svc, 0, "uint8"))
        assert len(calls) == 1  # nothing retried it
    finally:
        svc.close()


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the no-card check does not apply")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        t_serve.ScoringService(**{**SERVICE_KW, "device": "cuda"})
