"""Mean host milliseconds inside the program's step call per traced step,
measured under the profiler (which adds its own cost to each call)."""


def read(r):
    t = r.traced
    if t is None or not t.host_step_ms:
        return None
    return sum(t.host_step_ms) / len(t.host_step_ms)
