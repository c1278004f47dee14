"""Share of the traced stretch in which a copy between host and device runs."""
from stereo_bench.readers import copy_share as read  # noqa: F401
