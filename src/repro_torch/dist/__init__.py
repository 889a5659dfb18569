"""Step factories of the port: the serve step so far (see ``steps.py``)."""
