"""The share of device time in kernels that are neither the port's hand
kernels nor library matrix products: routing, dispatch, norms, elementwise
work. Copies and sets count in the whole, not in the share."""

import re

HAND = re.compile(r"repro::")
LIBRARY_GEMM = re.compile(r"gemm|gemv|xmma|cutlass|nvjet|cublas", re.IGNORECASE)
NOT_KERNEL = re.compile(r"^(Memcpy|Memset)")


def read(rec):
    t = rec.trace
    total = sum(t.device_s.values()) if t is not None else 0.0
    if total <= 0:
        return None
    other = sum(s for name, s in t.device_s.items()
                if not (HAND.search(name) or LIBRARY_GEMM.search(name) or NOT_KERNEL.search(name)))
    return 100.0 * other / total
