"""Model families of the port (dense decoder-only LM so far)."""
