"""Long-running services of the port (``serve/stream.py``)."""
