"""The most device memory allocated at once during the window (weights, KV
pool, activations), ``torch.cuda.max_memory_allocated`` after a reset at its
opening, in GiB."""


def read(rec):
    return rec.memory_peak_bytes / 2**30 if rec.memory_peak_bytes is not None else None
