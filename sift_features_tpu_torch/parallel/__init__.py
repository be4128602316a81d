"""Host pipelines around the card: the streaming executor."""

from .stream import stream_extract, stream_extract_paths  # noqa: F401
