"""The palette layout rule's reading of the order the pushes run, in %:
100 x single-palette row blocks over row blocks, from the pipeline's
`last_layout` after the window (the last order its blockwise test read:
the one it took, else the most sorted one it refused; the rule takes an
order at 50 or more).  Nothing to read where the pipeline keeps no
`last_layout` or its test read no whole block."""


def read(rec):
    layout = getattr(rec.run.pipe, "last_layout", None)
    if not layout or not layout["blocks"]:
        return None
    return 100.0 * layout["uniform"] / layout["blocks"]
