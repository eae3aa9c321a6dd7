"""queue_wait_share.serve: of the time requests spent in the engine, the
share they waited in its queue, in %: the host-clock durations of the
`serve.queued` spans (submit to admission; a preempted request queues
again) over those of the `serve.request` spans (submit to the tick that
returned it), over the requests whose spans all opened and closed in the
window (`repro_torch.spans`, keyed by request id).  None without spans.
Moves request_p95_ms."""
MOVES = "request_p95_ms"


def read(rec):
    try:
        from repro_torch import spans
    except ImportError:  # a program without spans
        return None
    got = spans.recorded().spans
    request = {s.key: s.seconds for s in got if s.name == "serve.request"}
    queued = {}
    for s in got:
        if s.name == "serve.queued" and s.key in request:
            queued[s.key] = queued.get(s.key, 0.0) + s.seconds
    total = sum(request[k] for k in queued)
    if total <= 0:
        return None
    return 100.0 * sum(queued.values()) / total
