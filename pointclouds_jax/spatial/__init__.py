"""pointclouds_jax.spatial"""
