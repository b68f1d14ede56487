"""Stage-I artifacts consumed by Stage II."""
