"""Mean rows a decode step advances: the tokens the decode steps produced
(every generated token but each request's first, which its last prefill
chunk gives) over the decode steps."""


def read(rec):
    n = rec.stats.get("decode_steps", 0)
    return (rec.generated - len(rec.requests)) / n if n else None
