"""Model public API of the port."""
from .io import INPUT_SHAPES, cache_specs, input_specs, make_batch, supported_shapes  # noqa: F401
from .params import init_params, param_pspecs, param_shapes, params_from_numpy  # noqa: F401
from .transformer import (  # noqa: F401
    DecodeCache,
    decode_step,
    embed_inputs,
    forward_hidden,
    init_cache,
    init_paged_cache,
    loss_and_aux,
    merge_cache_rows,
    prefill,
    unembed,
)
