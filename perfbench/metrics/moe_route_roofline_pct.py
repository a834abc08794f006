"""The token dispatch and combine kernels' share of their roofline: the
least time the H100 could take for the gather, the combine and both
backwards of the traced window's expert-layer calls (perfbench/costs/
moe.py, from the program's counters of token rows, held assignments and
tokens with one held) over the device time of the rows of those kernels
in the trace, named by their CUDA symbols. Each forward call of a
training step has its backward."""

from perfbench.costs import moe
from perfbench.metrics import _counts, _spans

KERNELS = ("moe_gather_kernel", "moe_combine_kernel",
           "moe_combine_bwd_kernel")
PRE = "fragnet.protein.moe."


def read(r):
    t = r.traced
    if t is None:
        return None
    dev = sum(b - a for n, a, b in t.device if any(k in n for k in KERNELS))
    tab = _spans.window_table(r)
    T, A, U = (_counts.total(tab, PRE + k)
               for k in ("rows", "assignments", "tokens_held"))
    if dev <= 0 or T is None or A is None or U is None:
        return None
    c = r.session.cfg
    bound = moe.route_bound_ms(T, A, U, c["hidden_size"],
                               c["num_experts_per_tok"])
    return 100.0 * bound / (dev * 1e3)
