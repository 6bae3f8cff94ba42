"""pointclouds_jax.utils"""
