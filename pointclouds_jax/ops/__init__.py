"""pointclouds_jax.ops"""
