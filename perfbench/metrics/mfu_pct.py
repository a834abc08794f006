"""Model operations of the traced steps (counted in perfbench/costs from
the batches' real shapes) over the traced window's seconds, as a share of
the H100's float32 peak outside the tensor cores (67 TFLOP/s, data
sheet). The configurations run float32 with TF32 off."""

from perfbench.costs.flops import F32_PEAK


def read(r):
    t = r.traced
    if t is None or t.window_s <= 0 or not t.device:
        return None
    return 100.0 * r.session.model_flops(t.steps) / (t.window_s * F32_PEAK)
