"""Runnable examples of the port (`python -m sift_features_tpu_torch.examples.<name>`)."""
