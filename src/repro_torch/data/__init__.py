"""Synthetic corpus and MLM batching (numpy only)."""
