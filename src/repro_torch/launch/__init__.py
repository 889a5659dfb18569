"""Command-line entry points of the port: serving so far (``serve.py``)."""
