"""Traffic and data generators, one per configuration kind, made from a seed."""
