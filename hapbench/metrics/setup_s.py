"""Process start to the window's opening: imports, the kernel library's
load (or build), the weights, the engine and the warm job."""


def read(rec):
    return rec.setup_s
