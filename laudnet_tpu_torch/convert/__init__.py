"""Weight converters from the JAX package's parameter trees."""
