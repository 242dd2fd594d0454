"""Share of the traced window in which no operation ran on the card: 1 -
(the union of the device's kernel, copy and set intervals) / window."""


def read(view):
    p = view.profile
    if p is None or not p.device or p.window_s <= 0:
        return None
    return 1.0 - p.busy_s() / p.window_s
