"""Model public API of the port."""
from .params import init_params, param_shapes, params_from_numpy  # noqa: F401
from .transformer import DecodeCache, decode_step, init_cache, prefill, unembed  # noqa: F401
