"""Distribution and host pipelines: the mesh of ranks, sharded extraction
(frames over `data`; one frame's rows over `space` with halo-exchange
blurs, parallel/halo.py), the ring-streamed matcher, the distributed
extract + match step, and the streaming executor."""

from .mesh import make_mesh, frames_sharding  # noqa: F401
from .extract import extract_batch_dp  # noqa: F401
from .ring import ring_match  # noqa: F401
from .pipeline import extract_match_step  # noqa: F401
from .stream import stream_extract, stream_extract_paths  # noqa: F401
