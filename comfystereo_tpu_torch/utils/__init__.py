"""Host-side utilities: the model and embedding caches, numpy fixtures,
profiling and the video loop."""
from . import caching, fixtures, profiling  # noqa: F401
