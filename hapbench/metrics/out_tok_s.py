"""Generated tokens of every job in the window over the window's wall time
(host clock): offline throughput."""


def read(rec):
    return rec.generated / rec.window_s if rec.window_s > 0 else None
