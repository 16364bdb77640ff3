"""Process meshes and collectives on ``torch.distributed`` — the port of
``byteps_tpu/parallel``'s data-parallel half (``mesh.py``,
``collectives.py``)."""
