"""Mean host ms of a step that gives the decoding rows a token (plain and
fused decode steps), from the engine's ``decode_step_ms_sum`` and
``decode_steps`` over the window."""


def read(rec):
    n = rec.stats.get("decode_steps", 0)
    return rec.stats["decode_step_ms_sum"] / n if n else None
