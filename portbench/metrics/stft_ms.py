"""Device ms per push (per tick in a served loop) of the operations that
layers/stft/*.json attribute to this layer, in the traced stretch: 0.0
where the stretch ran none of them."""


def read(rec):
    if rec.trace is None:
        return None
    return rec.trace.per_unit_ms("stft")
