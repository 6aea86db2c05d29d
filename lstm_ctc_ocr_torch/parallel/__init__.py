"""Data parallelism over ``torch.distributed`` (``parallel/mesh.py``) and its
multi-process dry run (``parallel/dryrun.py``)."""
