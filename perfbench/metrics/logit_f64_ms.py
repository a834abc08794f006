"""Device milliseconds per traced step in float64 GEMM rows: the GAT
logit terms, which the port sums in float64."""


def _f64_gemm(name):
    n = name.lower()
    return "dgemm" in n or ("f64" in n and ("gemm" in n or "xmma" in n))


def read(r):
    t = r.traced
    if t is None or not t.device or not t.steps:
        return None
    s = sum(b - a for n, a, b in t.device if _f64_gemm(n))
    return s * 1e3 / len(t.steps)
