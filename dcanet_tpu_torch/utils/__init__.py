"""Host-side utilities of the port: meters, metric logging, error maps."""
