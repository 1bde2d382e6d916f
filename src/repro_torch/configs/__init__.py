"""Architecture configs of the ported families (torch dtypes)."""
