"""Host ms a job spends capturing step graphs (``engine.steps.stats``): the
engine drops them with each live batch, so every job captures again."""


def read(rec):
    return rec.capture.get("capture_ms", 0.0) / rec.jobs if rec.jobs else None
