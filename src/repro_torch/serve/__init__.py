"""Serving in the port: the LM serving engine (``serve/engine.py``) and the
windowed DSC streaming service (``serve/stream.py``)."""
