"""Plain PyTorch and numpy references, one file a configuration
(``<config>.py``), with the shared blocks in ``plain.py``."""
