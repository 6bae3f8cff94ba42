"""pointclouds_jax.pipelines"""
