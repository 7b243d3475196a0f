"""Every stream-row the window completed (on the card, or in host memory
for a served loop), over the window's seconds on the host clock."""


def read(rec):
    if rec.window_s <= 0 or not rec.units:
        return None
    return rec.units * rec.rows_per_unit / rec.window_s
