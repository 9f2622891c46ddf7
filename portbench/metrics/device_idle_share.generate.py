"""device_idle_share: the share of the traced window in which no kernel,
copy or set ran on the device, from the profiler's trace."""


def read(w):
    if w.device is None or w.device.window_s <= 0:
        return None
    return 100.0 * (1.0 - w.device.busy_s / w.device.window_s)
