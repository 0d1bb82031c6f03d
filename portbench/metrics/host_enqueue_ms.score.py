"""Host ms per chunk inside `cli/score.score_batch` (normalize, both towers
and the score head launched; no read-back), by the host's clock around each
call in the traced window."""


def read(run):
    s = run.raw.get("enqueue_s") or []
    return 1e3 * sum(s) / len(s) if s else None
