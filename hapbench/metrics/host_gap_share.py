"""The share of the window outside the engine's steps: 1 minus the steps'
host time over the window. The steps' time is the engine's decode steps
(``decode_step_ms_sum``, fused steps included) plus the completions' unfused
prefill chunks (``prefill_ms``); each step ends in the token read-back, which
syncs. What is left is admission, block growth and live-batch set-up."""


def read(rec):
    if not rec.stats.get("decode_steps") or rec.window_s <= 0:
        return None
    steps_s = (rec.stats["decode_step_ms_sum"] + rec.prefill_ms) / 1e3
    return 100.0 * (1.0 - steps_s / rec.window_s)
