"""Model configurations at the JAX package's published widths (the
architecture registry waits for the model zoo)."""
