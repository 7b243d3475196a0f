"""The pipeline's host path: host ms inside each `push` call (which
returns before the card finishes), the mean over the window's pushes
outside the traced stretch."""


def read(rec):
    if not rec.enqueue_ms.size or rec.latency_of != "push":
        return None
    return float(rec.enqueue_ms.mean())
