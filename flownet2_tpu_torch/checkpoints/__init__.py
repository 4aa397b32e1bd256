from .torch_import import from_jax_variables, load_checkpoint  # noqa: F401
