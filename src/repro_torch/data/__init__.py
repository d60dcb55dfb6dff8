from .pipeline import synthetic_lm_data, synthetic_batches  # noqa: F401
