"""The chunk's floor (uint8 in and out once, or its operations) over the
traced stretch's time per chunk."""
from stereo_bench.readers import pass_mfu as read  # noqa: F401
