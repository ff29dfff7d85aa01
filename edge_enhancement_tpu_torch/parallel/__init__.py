"""Data parallelism over processes (`mesh.py`)."""
