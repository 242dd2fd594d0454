"""Model configurations at the JAX package's published widths, each
registered by its arch id in ``registry`` (the five LMs; the model zoo's
archs wait for ROADMAP §1 item 3)."""
