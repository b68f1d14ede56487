"""Stage II of the port: the scalar references and the batched engine."""
