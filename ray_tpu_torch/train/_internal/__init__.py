"""The trainer's controller, worker group and per-worker session."""
