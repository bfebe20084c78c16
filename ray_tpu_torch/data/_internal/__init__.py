"""Counterpart: ray_tpu/data/_internal/__init__.py (copied)."""
