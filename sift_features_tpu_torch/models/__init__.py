"""The extractor of the port: the end-to-end pipeline over the kernels."""
