"""The fleet: B filter replicas stepped together (parallel/sweep.py)."""
