"""MB (10^6 bytes) of device scratch the large-N STFT route wrote over in
the window's last push, from the pipeline's `last_stft` record (the
scratch of one row group, which each group's launch writes whole).
Nothing to read where the pipeline keeps no such record or its last push
took another route."""


def read(rec):
    last = getattr(rec.run.pipe, "last_stft", None)
    if not last or last.get("route") != "large":
        return None
    return last["scratch_bytes"] / 1e6
