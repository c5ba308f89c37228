"""The benchmark of ray_tpu_torch on the H100 (see README.md)."""
