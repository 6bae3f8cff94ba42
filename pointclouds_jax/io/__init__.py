"""pointclouds_jax.io"""
