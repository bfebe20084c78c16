"""Models of the port. Counterpart: ray_tpu/models/."""
