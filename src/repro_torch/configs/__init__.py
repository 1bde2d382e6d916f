"""Architecture configs of the dense decoder-only family (torch dtypes)."""
