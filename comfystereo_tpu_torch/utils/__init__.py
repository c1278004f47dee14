"""Host-side utilities: numpy fixtures and the video loop."""
