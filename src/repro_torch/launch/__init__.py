"""Entry points of the port: the training launcher (``launch/train.py``),
the serving launcher (``launch/serve.py``) and the one-device mesh they
run on (``launch/mesh.py``)."""
