"""Model configurations at the JAX package's published widths, each
registered by its arch id in ``registry``: the five LMs, gat-cora and the
four recsys models."""
