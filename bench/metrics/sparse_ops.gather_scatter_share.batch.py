"""Share of the device's busy time spent on the postings gather and the
slot scatters: the union of the device operations launched under the
program's ``sparse.gather`` or ``sparse.scatter`` spans (joined to their
launches by correlation id) over the union of all device operations in
the window."""
import spans


def read(view):
    s = spans.Spans.of(view.profile)
    t = None if s is None else s.device_seconds_under("sparse.gather",
                                                      "sparse.scatter")
    busy = 0.0 if t is None else view.profile.busy_s()
    return t / busy if busy > 0 else None
