"""Process start to the first timed push or tick: imports, the kernel
library (built on the first run in a checkout), the traffic, the state and
the warm-up."""


def read(rec):
    return rec.setup_s()
