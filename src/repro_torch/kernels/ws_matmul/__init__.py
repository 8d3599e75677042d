"""Weight- and output-stationary matmul (kernel wrappers and plain version)."""
