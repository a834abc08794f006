"""The GAT kernels' share of their roofline: the least time the H100
could take for the GAT passes of the traced steps (perfbench/costs/
kernels.py, from the batches' real nodes and edges) over the device time
of the rows of the port's GAT kernels K1, K2, K4, K5 and K6 in the
trace, named by their CUDA symbols."""

KERNELS = ("tcsr_gat_fwd_kernel", "tcsr_gat_bwd_kernel",
           "dense_gat_fwd_kernel", "dense_gat_bwd_kernel",
           "dense_planes_kernel")


def read(r):
    t = r.traced
    if t is None:
        return None
    dev = sum(b - a for n, a, b in t.device if any(k in n for k in KERNELS))
    if dev <= 0:
        return None
    return 100.0 * r.session.gat_bound_ms(t.steps) / (dev * 1e3)
