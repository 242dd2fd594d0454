"""Program-cache entries the program's query engine made in the window
(``engine_compiles_total``, all causes): 0 once set-up has warmed every
shape the cell uses."""


def read(view):
    n = view.counters.get("engine_compiles")
    return None if n is None else float(n)
