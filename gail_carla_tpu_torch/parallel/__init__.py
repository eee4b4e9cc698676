"""Training on more than one GPU: env data parallelism over
``torch.distributed`` (``mesh.py``) and the reductions the update makes
across ranks (``collectives.py``)."""
