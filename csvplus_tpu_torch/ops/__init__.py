"""Device operators: the fused mask kernel, filters, sorts and joins."""
