"""Entry points of the port: the training launcher (``launch/train.py``)
and the one-device mesh it runs on (``launch/mesh.py``)."""
