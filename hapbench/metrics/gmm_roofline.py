"""``grouped_matmul``'s share of its roofline: the least time its launches
could take over the device time its kernels took. Least time is the sum,
over the launches by shape (E, C, K, N) of the window, of the larger of
2*E*C*K*N / the bf16 peak and the bytes (weights, input slab and output, once)
/ the HBM rate (``hapbench.counts``)."""

from hapbench import counts


def read(rec):
    t = rec.trace
    if t is None:
        return None
    device = sum(s for name, s in t.device_s.items() if "grouped_matmul" in name)
    least = 0.0
    for (kernel, shape), n in rec.shapes.items():
        if kernel == "grouped_matmul":
            least += n * counts.least_time_s(*counts.gmm_work(*shape))[0]
    return 100.0 * least / device if device > 0 and least > 0 else None
