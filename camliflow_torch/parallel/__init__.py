"""Data parallelism: one process a card (`parallel/dist.py`)."""
