"""Jobs, one module per traffic kind: set-up, one unit of work, its answer."""
