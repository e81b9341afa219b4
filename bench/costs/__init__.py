"""Frozen peaks and the operation and byte counts of the benchmark."""
