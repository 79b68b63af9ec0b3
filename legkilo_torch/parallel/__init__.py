"""The fleet: B filter replicas stepped together (parallel/sweep.py), sharded
over ranks, one process a card (multihost.py, mesh.py, scaling.py)."""
