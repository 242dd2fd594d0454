"""Chunk and pinned-program dispatches of the program's query engine
(``engine_dispatches_total``) over the window, per query completed."""


def read(view):
    q = view.work.get("queries")
    if not q:
        return None
    return view.counters["engine_dispatches"] / q
