"""Items the window completed over the window's seconds, by the host's
clock: the window closes when the device has finished its last step."""


def read(r):
    if r.window_s is None:
        return None
    return r.steps * r.session.items_per_step / r.window_s
