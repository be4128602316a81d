"""Host-side I/O of the port: the persistent descriptor database."""
