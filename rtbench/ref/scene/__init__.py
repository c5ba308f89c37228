"""Frozen copy of the port's plain path (see rtbench/ref/__init__.py)."""
