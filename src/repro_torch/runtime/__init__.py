"""Runtime of the port: the continuous-batching serving engine."""
