"""Counterpart: ray_tpu/scripts/__init__.py (empty in both)."""
