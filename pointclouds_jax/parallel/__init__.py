"""pointclouds_jax.parallel"""
