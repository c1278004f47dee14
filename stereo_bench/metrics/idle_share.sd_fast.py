"""Share of the traced stretch with no kernel, copy or memset on the device."""
from stereo_bench.readers import idle_share as read  # noqa: F401
