"""Deep front-end models in PyTorch: SuperPoint and LightGlue.

Each module loads the upstream torch checkpoint layout directly and carries
the JAX package's Flax parameters across with ``params_from_jax``."""
