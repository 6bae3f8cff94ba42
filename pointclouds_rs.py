"""Drop-in compatibility shim: the reference library's module name.

Lets unmodified scripts written against the Rust ``pointclouds_rs`` bindings
(e.g. the reference's examples and pytest suite) run on the JAX
implementation: ``import pointclouds_rs`` resolves to ``pointclouds_jax``.
"""

from pointclouds_jax import *  # noqa: F401,F403
from pointclouds_jax import __all__  # noqa: F401
