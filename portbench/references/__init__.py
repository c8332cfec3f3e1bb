"""Plain references, one a family of configurations."""
