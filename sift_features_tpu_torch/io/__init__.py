"""Host-side I/O of the port: image loading, the native decode and output
tiers, the golden snapshot parsers and the persistent descriptor database."""
