"""Utilities of the runtime (the port of ray_tpu/util/ that it needs)."""
