"""Model public API of the port."""
from .params import init_params, param_shapes, params_from_numpy  # noqa: F401
from .transformer import (  # noqa: F401
    DecodeCache,
    decode_step,
    init_cache,
    init_paged_cache,
    merge_cache_rows,
    prefill,
    unembed,
)
